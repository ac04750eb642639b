"""Generic Darknet ``.cfg`` parser and model builder.

Port of ``tmv_tpu/convert/darknet_cfg.py`` (parity with the reference's
`yolo_v3/convert.py:44-270`, which builds its model from the cfg file, so that
any Darknet architecture of these sections imports its ``.weights``):
``parse_darknet_cfg`` (a copy) reads the sections with the reference's
unique-section counting, ``DarknetCfgNet`` is an ``nn.Module`` that interprets
them, and because its convs run in cfg order the traced-order importer
(``convert.darknet``) loads ``.weights`` into it directly.

Sections: ``[convolutional]`` (filters/size/stride/batch_normalize/activation
leaky | mish | linear, any other name as linear; stride 2 with Darknet's top-left pad), ``[shortcut]``
(a residual add with layer ``from``), ``[route]`` (concat of ``layers``,
negative = relative, with ``groups``/``group_id`` slicing), ``[upsample]``
(nearest ×2), ``[maxpool]`` (size/stride, SAME) and ``[yolo]`` (marks the
previous layer as a detection output). Torch modules need their input channels
when they are built, so the constructor tracks each section's channels; a
section it does not know raises when the net runs, as in the JAX package. The
input has 3 channels, as the JAX package's trace assumes.
Submodules carry the flax auto-names (``ConvBN_k``, ``DarknetConv_k`` in cfg
order); NHWC in, NHWC heads out, ``channels_last`` inside.
"""

import io
from typing import List, Tuple

import torch
import torch.nn as nn

from tmv_tpu_torch.models.layers.common import (
    ACTIVATIONS, ConvBN, DarknetConv, max_pool_same, upsample2x,
)

Section = Tuple[str, Tuple[Tuple[str, str], ...]]


def parse_darknet_cfg(cfg) -> Tuple[Section, ...]:
    """Parse a Darknet cfg file/path/text into ((name, ((k, v), ...)), ...).

    Duplicate section names get ``_N`` suffixes in order of appearance
    (same scheme as the reference's ``unique_config_sections``).
    """
    if hasattr(cfg, "read"):
        text = cfg.read()
    elif "\n" in cfg or "[" == cfg.lstrip()[:1]:
        text = cfg
    else:
        with open(cfg) as f:
            text = f.read()

    sections: List[Tuple[str, List[Tuple[str, str]]]] = []
    counters: dict = {}
    for raw in io.StringIO(text):
        line = raw.split("#")[0].split(";")[0].strip()
        if not line:
            continue
        if line.startswith("["):
            name = line.strip("[]").strip()
            n = counters.get(name, 0)
            counters[name] = n + 1
            sections.append((f"{name}_{n}", []))
        else:
            if "=" not in line or not sections:
                continue
            k, v = line.split("=", 1)
            sections[-1][1].append((k.strip(), v.strip()))
    return tuple((name, tuple(kvs)) for name, kvs in sections)


class DarknetCfgNet(nn.Module):
    """Interpreter of a parsed Darknet cfg: NHWC image → the ``[yolo]`` layers'
    outputs (NHWC), or the last layer's where there is none."""

    def __init__(self, sections: Tuple[Section, ...], dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.layers: List[Tuple[str, dict, str]] = []   # (kind, options, module name)
        widths: List[int] = []
        counts = {"ConvBN": 0, "DarknetConv": 0}
        c = 3
        for name, kvs in sections:
            kind, o = name.rsplit("_", 1)[0], dict(kvs)
            if kind in ("net", "network"):
                continue
            module_name = None
            if kind == "convolutional":
                filters, size = int(o["filters"]), int(o.get("size", 1))
                stride = int(o.get("stride", 1))
                with_bn = "batch_normalize" in o and o["batch_normalize"] != "0"
                if o.get("activation") not in ("leaky", "mish"):
                    o["activation"] = "linear"
                base = "ConvBN" if with_bn else "DarknetConv"
                module_name = f"{base}_{counts[base]}"
                counts[base] += 1
                if with_bn:
                    module = ConvBN(c, filters, size, strides=stride, act=o["activation"], **kw)
                else:
                    module = DarknetConv(c, filters, size, strides=stride, use_bias=True, **kw)
                self.add_module(module_name, module)
                c = filters
            elif kind == "route":
                ids = [int(v) for v in o["layers"].split(",")]
                c = sum(widths[i] for i in ids) // int(o.get("groups", 1))
            self.layers.append((kind, o, module_name))
            widths.append(c)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        outputs: List[torch.Tensor] = []
        heads: List[torch.Tensor] = []
        for kind, o, module_name in self.layers:
            if kind == "convolutional":
                x = getattr(self, module_name)(x)
                if module_name.startswith("DarknetConv"):
                    x = ACTIVATIONS[o["activation"]](x)
            elif kind == "shortcut":
                x = x + outputs[int(o["from"])]
            elif kind == "route":
                feats = [outputs[int(v)] for v in o["layers"].split(",")]
                x = feats[0] if len(feats) == 1 else torch.cat(feats, dim=1)
                groups = int(o.get("groups", 1))
                if groups > 1:
                    gid, c = int(o.get("group_id", 0)), x.shape[1] // groups
                    x = x[:, gid * c:(gid + 1) * c]
            elif kind == "upsample":
                x = upsample2x(x)
            elif kind == "maxpool":
                size = int(o.get("size", 2))
                x = max_pool_same(x, size, int(o.get("stride", size)))
            elif kind == "yolo":
                heads.append(outputs[-1] if outputs else x)
            else:
                raise ValueError(f"unsupported darknet section [{kind}]")
            outputs.append(x)
        if heads:
            return tuple(h.permute(0, 2, 3, 1) for h in heads)
        return x.permute(0, 2, 3, 1)


def build_from_cfg(cfg, dtype: torch.dtype = torch.float32, device="cuda"):
    """cfg (path/text/file) → (DarknetCfgNet on ``device``, input (h, w) from
    [net])."""
    from tmv_tpu_torch.models.detector_harness import check_device

    sections = parse_darknet_cfg(cfg)
    net_opts = next((dict(kvs) for name, kvs in sections if name.startswith("net")), {})
    h, w = int(net_opts.get("height", 416)), int(net_opts.get("width", 416))
    return DarknetCfgNet(sections, dtype=dtype, device=check_device(device)), (h, w)


def load_cfg_weights(cfg, weights_file, dtype: torch.dtype = torch.float32, device="cuda"):
    """cfg + ``.weights`` → the model with the weights loaded (the reference's
    ``convert.py _main``: cfg → model → weight assignment)."""
    from tmv_tpu_torch.convert.darknet import load_darknet_weights

    model, (h, w) = build_from_cfg(cfg, dtype=dtype, device=device)
    return load_darknet_weights(model, weights_file, input_size=(h, w))
