"""Darknet ``.weights`` importer and exporter for the port's YOLO models.

Port of ``tmv_tpu/convert/darknet.py`` (parity with the reference's
`yolo_v3/convert.py` + `convert_tf2.py`). Format: a header of 3 int32 (major,
minor, revision) and the images seen (int64 from version 0.2 on, int32
before), then for each convolutional layer in *config order* either its
``bias`` or ``bn_beta, bn_gamma, bn_mean, bn_var``, followed by its weights in
``(out, in, h, w)`` order — torch's OIHW, so no transpose is needed.

The stream order is the order in which the convs *execute*, not the order of
``named_modules()`` (a module registered early may be called late). So
``conv_call_order`` traces one forward on the meta device (no arithmetic,
no copy of the weights) with forward pre-hooks on every conv (``nn.Conv2d``
called as a module, and the port's ``DarknetConv``, which calls its
``Conv_0`` functionally) and every BatchNorm, and each conv is paired with the
BatchNorm that runs right after it, or with its own bias.
``save_darknet_weights`` is the inverse, so the mapping round-trips without the
original weight files.
"""

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.models.layers.common import DarknetConv


def conv_call_order(model: nn.Module, input_size=416, channels: int = 3
                    ) -> List[Tuple[str, str]]:
    """``[("conv" | "bn", module name), …]`` in the order the model calls them
    on a ``(1, h, w, channels)`` NHWC input, traced on the meta device in eval
    mode."""
    h, w = (input_size, input_size) if isinstance(input_size, int) else input_size
    convs = {m: f"{name}.Conv_0" for name, m in model.named_modules()
             if isinstance(m, DarknetConv)}
    convs.update({m: name for name, m in model.named_modules() if isinstance(m, nn.Conv2d)})
    bns = {m: name for name, m in model.named_modules() if isinstance(m, nn.BatchNorm2d)}
    order: List[Tuple[str, str]] = []

    def record(module, _inputs):
        kind, name = ("conv", convs[module]) if module in convs else ("bn", bns[module])
        if not order or order[-1][1] != name:
            order.append((kind, name))

    meta = {k: torch.empty_like(v, device="meta")
            for k, v in model.state_dict(keep_vars=True).items()}
    hooks = [m.register_forward_pre_hook(record) for m in (*convs, *bns)]
    training = model.training
    try:
        model.eval()
        with torch.no_grad():
            torch.func.functional_call(model, meta, (torch.zeros((1, h, w, channels),
                                                                 device="meta"),))
    finally:
        model.train(training)
        for hook in hooks:
            hook.remove()
    return order


def conv_specs(model: nn.Module, input_size=416, channels: int = 3) -> List[Dict]:
    """The traced convs in call order, each paired with the BatchNorm that
    follows it, or its bias: ``[{"conv": name, "bias": bool, "bn": name
    (absent without one)}, …]``."""
    modules = dict(model.named_modules())
    specs: List[Dict] = []
    for kind, name in conv_call_order(model, input_size, channels):
        if kind == "conv":
            specs.append({"conv": name, "bias": modules[name].bias is not None})
        else:   # a BatchNorm belongs to the conv that just ran
            if not specs or "bn" in specs[-1]:
                raise ValueError(f"BatchNorm at {name} does not follow a conv — "
                                 "unsupported architecture for darknet import")
            specs[-1]["bn"] = name
    return specs


def _open(weights_file, mode):
    if isinstance(weights_file, (str, bytes)):
        return open(weights_file, mode), True
    return weights_file, False


def load_darknet_weights(model: nn.Module, weights_file, *, input_size=416,
                         channels: int = 3) -> nn.Module:
    """Fill ``model``'s conv weights and biases and BatchNorm parameters and
    running statistics, in place, from a Darknet weights stream (a path or a
    binary file-like). Raises, naming the conv, where the stream is too short,
    and where bytes are left over. Returns ``model``."""
    specs = conv_specs(model, input_size, channels)
    modules = dict(model.named_modules())
    f, close = _open(weights_file, "rb")
    try:
        major, minor, _revision = struct.unpack("<3i", f.read(12))
        if major * 10 + minor >= 2 and major < 1000 and minor < 1000:
            f.read(8)   # seen: int64
        else:
            f.read(4)   # seen: int32
        with torch.no_grad():
            for i, spec in enumerate(specs):
                conv = modules[spec["conv"]]
                out_f, in_f, kh, kw = conv.weight.shape
                need = 4 * out_f * (4 if "bn" in spec else (1 if spec["bias"] else 0))
                need += 4 * out_f * in_f * kh * kw
                buf = f.read(need)
                if len(buf) < need:
                    raise ValueError(
                        f"weights stream exhausted at conv {i}/{len(specs)} ({spec['conv']}, "
                        f"{kh}x{kw}x{in_f}->{out_f}): architecture/weights mismatch")
                values = np.frombuffer(buf, np.float32)
                off = 0

                def take(n):
                    nonlocal off
                    off += n
                    return torch.from_numpy(values[off - n:off].copy())

                if "bn" in spec:
                    bn = modules[spec["bn"]]
                    for tensor in (bn.bias, bn.weight, bn.running_mean, bn.running_var):
                        tensor.copy_(take(out_f))
                elif spec["bias"]:
                    conv.bias.copy_(take(out_f))
                conv.weight.copy_(take(out_f * in_f * kh * kw).reshape(out_f, in_f, kh, kw))
        leftover = f.read()
        if leftover:
            raise ValueError(f"{len(leftover)} unread bytes after {len(specs)} convs: "
                             "architecture/weights mismatch")
    finally:
        if close:
            f.close()
    return model


def _bytes(tensor: torch.Tensor) -> bytes:
    return tensor.detach().to("cpu", torch.float32).contiguous().numpy().tobytes()


def save_darknet_weights(model: nn.Module, weights_file, *, input_size=416, channels: int = 3):
    """Inverse of ``load_darknet_weights``: a version 0.2 header and every conv
    in call order."""
    specs = conv_specs(model, input_size, channels)
    modules = dict(model.named_modules())
    f, close = _open(weights_file, "wb")
    try:
        f.write(struct.pack("<3i", 0, 2, 0))
        f.write(struct.pack("<q", 0))
        for spec in specs:
            conv = modules[spec["conv"]]
            if "bn" in spec:
                bn = modules[spec["bn"]]
                for tensor in (bn.bias, bn.weight, bn.running_mean, bn.running_var):
                    f.write(_bytes(tensor))
            elif spec["bias"]:
                f.write(_bytes(conv.bias))
            f.write(_bytes(conv.weight))
    finally:
        if close:
            f.close()
