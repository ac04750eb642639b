"""Keras-h5 name-mapped checkpoint importer and exporter.

Port of ``tmv_tpu/convert/h5_import.py`` (parity with the reference's
`yolo_v3/convert_tf2.py:22-48`): the ``.h5`` written by the reference's Darknet
converter (a Keras functional model) lists its layers in creation order in the
``layer_names`` attribute, which for converter output is the Darknet cfg order;
so the ordered (conv, bn) stream maps onto the port's conv *call order* traced
by ``convert.darknet.conv_call_order``. A Keras kernel is ``(h, w, in, out)``
and becomes torch's OIHW; a BatchNorm maps gamma → weight, beta → bias,
moving_mean/variance → running_mean/var. ``save_keras_h5_weights`` writes the
same layout (Keras layer and weight names), so the mapping round-trips without
reference weights. ``h5py`` is imported inside the functions that need it.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.convert.darknet import conv_specs

_BN_KEYS = ("gamma", "beta", "moving_mean", "moving_variance")


def _decode(s):
    return s.decode("utf8") if isinstance(s, bytes) else s


def read_keras_h5(h5_file) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """h5 → ordered [('conv'|'bn', {weight_name: array}), ...].

    Order comes from the file's ``layer_names`` attribute (layer creation
    order).  Weightless layers (padding, upsample, ...) are skipped.
    """
    import h5py

    with h5py.File(h5_file, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        items: List[Tuple[str, Dict[str, np.ndarray]]] = []
        for ln in [_decode(s) for s in g.attrs["layer_names"]]:
            grp = g[ln]
            wnames = [_decode(s) for s in grp.attrs.get("weight_names", [])]
            if not wnames:
                continue
            weights = {
                wn.split("/")[-1].split(":")[0]: np.asarray(grp[wn])
                for wn in wnames
            }
            if "kernel" in weights:
                items.append(("conv", weights))
            elif any(k in weights for k in _BN_KEYS):
                items.append(("bn", weights))
        return items


def _hwio(tensor: torch.Tensor) -> Tuple[int, ...]:
    """A conv weight's shape in Keras' (h, w, in, out) order."""
    return tuple(tensor.permute(2, 3, 1, 0).shape) if tensor.dim() == 4 else tuple(tensor.shape)


def load_keras_h5_weights(model: nn.Module, h5_file, *, input_size=416, channels: int = 3,
                          strict: bool = True) -> List:
    """Fill ``model`` in place from a Keras functional-model h5.

    ``strict``: raise on a shape mismatch; if False, skip the weight with a
    report entry (the reference prints and skips, `convert_tf2.py:44-46`).
    Returns ``skipped``: ``(h5_layer_index, torch key, h5_shape,
    expected_shape)`` of each weight not assigned, shapes in Keras order (empty
    when strict).
    """
    specs = conv_specs(model, input_size, channels)
    modules = dict(model.named_modules())
    items = read_keras_h5(h5_file)
    skipped: List = []
    it = iter(enumerate(items))

    def next_item(kind, for_name):
        try:
            i, (k, w) = next(it)
        except StopIteration:
            raise ValueError(f"h5 exhausted: no {kind} layer left for {for_name} — "
                             "architecture/h5 mismatch") from None
        if k != kind:
            raise ValueError(f"h5 layer {i} is a {k}, expected {kind} for {for_name} — "
                             "architecture/h5 mismatch")
        return i, w

    def assign(i, module_name, attr, value):
        tensor = getattr(modules[module_name], attr)
        if _hwio(tensor) != tuple(value.shape):
            if strict:
                raise ValueError(f"shape mismatch at h5 layer {i} → {module_name}.{attr}: "
                                 f"h5 {tuple(value.shape)} vs model {_hwio(tensor)}")
            skipped.append((i, f"{module_name}.{attr}", tuple(value.shape), _hwio(tensor)))
            return
        value = torch.from_numpy(np.asarray(value, np.float32))
        tensor.copy_(value.permute(3, 2, 0, 1) if value.dim() == 4 else value)

    with torch.no_grad():
        for spec in specs:
            i, w = next_item("conv", spec["conv"])
            assign(i, spec["conv"], "weight", w["kernel"])
            if spec["bias"] and "bias" in w:
                assign(i, spec["conv"], "bias", w["bias"])
            if "bn" in spec:
                i, w = next_item("bn", spec["bn"])
                for attr, key in (("weight", "gamma"), ("bias", "beta"),
                                  ("running_mean", "moving_mean"),
                                  ("running_var", "moving_variance")):
                    assign(i, spec["bn"], attr, w[key])
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} unconsumed h5 weight layers (first: index "
                         f"{rest[0][0]}, kind {rest[0][1][0]}) — architecture/h5 mismatch")
    return skipped


def save_keras_h5_weights(model: nn.Module, h5_file, *, input_size=416, channels: int = 3):
    """Inverse of ``load_keras_h5_weights`` (Keras-compatible layout)."""
    import h5py

    specs = conv_specs(model, input_size, channels)
    modules = dict(model.named_modules())

    def array(tensor):
        a = tensor.detach().to("cpu", torch.float32)
        return (a.permute(2, 3, 1, 0) if a.dim() == 4 else a).contiguous().numpy()

    with h5py.File(h5_file, "w") as f:
        layer_names = []

        def put(name, weights):
            grp = f.create_group(name) if name not in f else f[name]
            wnames = []
            for wn, val in weights.items():
                full = f"{name}/{wn}:0"
                grp.create_dataset(full, data=array(val))
                wnames.append(full.encode("utf8"))
            grp.attrs["weight_names"] = wnames
            layer_names.append(name.encode("utf8"))

        conv_i = bn_i = 0
        for spec in specs:
            conv = modules[spec["conv"]]
            weights = {"kernel": conv.weight}
            if spec["bias"]:
                weights["bias"] = conv.bias
            put(f"conv2d_{conv_i}" if conv_i else "conv2d", weights)
            conv_i += 1
            if "bn" in spec:
                bn = modules[spec["bn"]]
                put(f"batch_normalization_{bn_i}" if bn_i else "batch_normalization",
                    {"gamma": bn.weight, "beta": bn.bias, "moving_mean": bn.running_mean,
                     "moving_variance": bn.running_var})
                bn_i += 1
        f.attrs["layer_names"] = layer_names
