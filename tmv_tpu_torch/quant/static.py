"""Static-calibration int8 quantization for the serving path.

Port of ``tmv_tpu/quant/static.py``. Activation scales are calibrated offline (one
absmax per conv input, max-reduced over a calibration set) and the weights are
quantized once, per output channel, on the host; each conv then quantizes its input
with the static scale (``kernels/int8_conv.py``: a quantize pass before the GEMM,
or the depthwise kernel's staged tile): no runtime statistics pass.

- ``calibrate_model`` runs the model's forward in ``quantized("calib")``; every conv
  site records the per-input-channel ``amax`` of its input over batch and space,
  max-reduced over repeated calls (the BiFPN and head SeparableConvs run at five
  levels) and over batches. The result is a flat dict keyed by the site's module path
  and leaf, the JAX ``quant_stats`` tree's names joined by dots (``ConvBN_0.in_absmax``,
  ``backbone.MBConvBlock_3.in_absmax_Conv_1``), so that
  ``convert/flax_bridge.py::quant_stats_from_flax`` maps a JAX tree onto it.
- ``prepare_static_int8`` is ``prepare_static_int8_variables``: per-tensor
  ``in_absmax = max(max·margin, 1e-6)``, or per-channel ``a_c`` folded into the
  kernel's input axis (grouped-aware), then per-output-channel ``w_absmax`` and
  ``kernel_q`` rounded half to even and clipped to ±127, in numpy as the JAX package
  computes them. Each site gets them as **non-persistent buffers**, with the
  epilogue they imply (``deq``, ``offset``: the BN affine or the conv bias folded in,
  in JAX's order of operations), so the ``state_dict`` and checkpoints are unchanged,
  as JAX adds a ``quant`` collection beside ``params`` and ``batch_stats``. Prepare
  after loading the weights: the buffers are a function of them.
- ``static_int8_conv`` is the JAX function on the port's layouts; ``static_conv_site``
  runs one prepared site of a module; ``calibrate_directory`` letterboxes a directory
  of images as the server does and prepares the model (``serve --int8Static``).
"""

import os
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.kernels.int8_conv import (
    int8_conv, int8_dwconv, pack_dense, pack_depthwise, true_div,
)
from tmv_tpu_torch.quant.dynamic import quant_mode, quantized, shard_conv_input

_CALIB = threading.local()
LEAVES = ("in_absmax", "kernel_q", "w_absmax", "deq", "offset")


def record(module: nn.Module, leaf: str, x: torch.Tensor):
    """In ``quantized("calib")`` under ``calibrate_absmax``: max-reduce the
    per-channel absmax of ``x`` (over batch and space) into the site ``leaf`` of
    ``module`` (``in_absmax`` for a ConvBN, ``in_absmax_<conv>`` for a module with
    several convs). A no-op otherwise, and in train mode."""
    names = getattr(_CALIB, "names", None)
    if quant_mode() != "calib" or module.training or names is None or id(module) not in names:
        return
    prefix = names[id(module)]
    key = f"{prefix}.{leaf}" if prefix else leaf
    amax = x.detach().abs().amax(dim=(0, 2, 3)).float()
    stats = _CALIB.stats
    stats[key] = amax if key not in stats else torch.maximum(stats[key], amax)


def calibrate_absmax(model: nn.Module, apply_fn: Callable, batches: Iterable) -> Dict[str, np.ndarray]:
    """Run ``apply_fn(batch)`` (a forward of ``model`` in eval mode) over ``batches``
    in calibration mode → ``{site path.leaf: per-input-channel absmax}``. The caller
    must not already be inside a ``quantized()`` context."""
    _CALIB.names = {id(m): name for name, m in model.named_modules()}
    _CALIB.stats = {}
    try:
        with quantized("calib"), torch.inference_mode():
            n = 0
            for batch in batches:
                apply_fn(batch)
                n += 1
        stats = {k: v.cpu().numpy().astype(np.float32) for k, v in _CALIB.stats.items()}
    finally:
        _CALIB.names = _CALIB.stats = None
    if n == 0:
        raise ValueError("calibration set is empty")
    return stats


def calibrate_model(model: nn.Module, batches: Iterable) -> Dict[str, np.ndarray]:
    """``calibrate_absmax`` of the model's forward on each batch of NHWC float
    images (numpy or tensors), moved to the model's device as float32."""
    device = next(model.parameters()).device

    def apply_fn(batch):
        return model(torch.as_tensor(batch).to(device=device, dtype=torch.float32))

    return calibrate_absmax(model, apply_fn, batches)


def site_parts(module: nn.Module, suffix: str):
    """(conv, BatchNorm or None) of the site ``suffix`` of ``module``: a ConvBN's
    (``""``) conv and BatchNorm, else the conv named by the suffix and, for a
    ``Conv_i``, the module's ``BatchNorm_i``."""
    if suffix == "":
        return module.DarknetConv_0.Conv_0, module.BatchNorm_0
    name = suffix[1:]
    conv = getattr(module, name)
    bn = getattr(module, "BatchNorm_" + name[len("Conv_"):], None) if name.startswith("Conv_") else None
    return conv, bn


def static_epilogue(in_absmax: torch.Tensor, w_absmax: torch.Tensor,
                    out_scale: Optional[torch.Tensor] = None,
                    out_offset: Optional[torch.Tensor] = None):
    """(deq, offset) of a static site in the JAX package's order of operations: the
    per-channel activation scales were folded into the weights, so ``deq =
    w_absmax / 127²``; per tensor ``deq = (a / 127)·(w_absmax / 127)``; then
    ``· out_scale``."""
    w_absmax = w_absmax.float()
    if in_absmax.dim():
        deq = true_div(w_absmax, 127.0 * 127.0)
    else:
        deq = true_div(in_absmax, 127.0) * true_div(w_absmax, 127.0)
    if out_scale is not None:
        deq = deq * out_scale.float()
    offset = None if out_offset is None else out_offset.float().contiguous()
    return deq.contiguous(), offset


def bn_affine(bn, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(γ / √(var + ε), β − mean·scale) of an eval-mode BatchNorm, float32, on
    ``device`` (the BatchNorm's own where None)."""
    weight, bias, mean, var = (t.detach().float() if device is None else
                               t.detach().float().to(device)
                               for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var))
    scale = weight / torch.sqrt(var + bn.eps)
    return scale, bias - mean * scale


def install_site(module: nn.Module, suffix: str, in_absmax, kernel_q_hwio, w_absmax):
    """Register a site's ``in_absmax``, ``kernel_q`` (in the kernel's layout),
    ``w_absmax`` and epilogue as non-persistent buffers of ``module``."""
    conv, bn = site_parts(module, suffix)
    device = conv.weight.device
    in_absmax = torch.tensor(np.asarray(in_absmax, np.float32))
    w_absmax = torch.tensor(np.asarray(w_absmax, np.float32))
    kq = torch.tensor(np.asarray(kernel_q_hwio, np.int8))
    depthwise = conv.groups > 1
    if depthwise and (conv.groups != conv.in_channels or kq.shape[2] != 1):
        raise ValueError(f"site {suffix or 'ConvBN'}: only groups 1 and depthwise convs")
    packed = pack_depthwise(kq) if depthwise else pack_dense(kq)
    with torch.no_grad():
        if bn is not None:
            deq, offset = static_epilogue(in_absmax, w_absmax, *bn_affine(bn, "cpu"))
        else:
            bias = None if conv.bias is None else conv.bias.detach().cpu()
            deq, offset = static_epilogue(in_absmax, w_absmax, None, bias)
    for leaf, value in zip(LEAVES, (in_absmax, packed, w_absmax, deq, offset)):
        module.register_buffer(leaf + suffix, None if value is None else value.to(device),
                               persistent=False)


def prepare_static_int8(model: nn.Module, absmax_tree: Dict[str, np.ndarray],
                        margin: float = 1.0, per_channel: bool = False) -> nn.Module:
    """Bake calibrated scales and pre-quantized weights into ``model``'s sites
    (non-persistent buffers; the ``state_dict`` is unchanged) → ``model``.

    ``margin`` multiplies the calibrated absmax (< 1 clips outliers);
    ``per_channel`` quantizes activations with per-input-channel scales folded into
    the weights' input axis (grouped-conv aware: kernel ``[..., i, o]`` consumes input
    channel ``(o // (O//g))·I + i``), then per-output quantization."""
    for path, absmax in absmax_tree.items():
        if isinstance(absmax, (tuple, list)):
            absmax = absmax[0]
        absmax = np.asarray(absmax, np.float32)
        site, leaf = path.rsplit(".", 1) if "." in path else ("", path)
        suffix = "" if leaf == "in_absmax" else "_" + leaf[len("in_absmax_"):]
        module = model.get_submodule(site)
        conv, _ = site_parts(module, suffix)
        kernel = conv.weight.detach().float().cpu().permute(2, 3, 1, 0).numpy()  # HWIO
        if per_channel and absmax.ndim == 1:
            a_vec = np.maximum(absmax * margin, 1e-6).astype(np.float32)
            h, w, i_dim, o_dim = kernel.shape
            groups = a_vec.size // i_dim
            if a_vec.size % i_dim or o_dim % max(groups, 1):
                raise ValueError(f"kernel {kernel.shape} does not divide the "
                                 f"{a_vec.size}-channel activation at {path}")
            ch = ((np.arange(o_dim)[None, :] // (o_dim // groups)) * i_dim
                  + np.arange(i_dim)[:, None])              # (I, O)
            w_scaled = kernel * a_vec[ch][None, None]
            w_absmax = np.maximum(
                np.max(np.abs(w_scaled), axis=(0, 1, 2)), 1e-12).astype(np.float32)
            kernel_q = np.clip(
                np.round(w_scaled * (127.0 / w_absmax)), -127, 127).astype(np.int8)
            in_leaf = a_vec
        else:
            w_absmax = np.maximum(
                np.max(np.abs(kernel), axis=(0, 1, 2)), 1e-12).astype(np.float32)
            kernel_q = np.clip(
                np.round(kernel * (127.0 / w_absmax)), -127, 127).astype(np.int8)
            in_leaf = np.float32(max(float(absmax.max()) * margin, 1e-6))
        install_site(module, suffix, in_leaf, kernel_q, w_absmax)
    return model


def _int8_site_conv(x, kernel_q, in_absmax, deq, offset, kernel_size, stride, padding,
                    depthwise: bool, out_dtype):
    x, pads = shard_conv_input(x, kernel_size, stride, padding)
    x = x.contiguous(memory_format=torch.channels_last)
    if depthwise:
        return int8_dwconv(x, kernel_q, in_absmax, deq, offset, kernel_size[0], stride, pads,
                           out_dtype=out_dtype)
    return int8_conv(x, kernel_q, in_absmax, deq, offset, kernel_size, stride, pads,
                     out_dtype=out_dtype)


def static_int8_conv(x: torch.Tensor, kernel_q: torch.Tensor, in_absmax: torch.Tensor,
                     w_absmax: torch.Tensor, kernel_size: Tuple[int, int], stride: int = 1,
                     padding: Union[str, Sequence[int]] = "SAME",
                     out_scale: Optional[torch.Tensor] = None,
                     out_offset: Optional[torch.Tensor] = None,
                     groups: int = 1) -> torch.Tensor:
    """int8×int8→int32 convolution with a *static* activation scale → float32
    channels_last. ``kernel_q`` is in the kernel's layout (``pack_dense``, or
    ``pack_depthwise`` for ``groups`` = C); ``in_absmax`` a scalar or a
    per-input-channel vector already folded into ``kernel_q``/``w_absmax``."""
    if groups not in (1, x.shape[1]):
        raise ValueError(f"static_int8_conv: groups {groups} of {x.shape[1]} channels")
    deq, offset = static_epilogue(in_absmax, w_absmax, out_scale, out_offset)
    return _int8_site_conv(x, kernel_q, in_absmax, deq, offset, kernel_size, stride, padding,
                           groups > 1, torch.float32)


def static_conv_site(module: nn.Module, suffix: str, x: torch.Tensor,
                     kernel_size: Tuple[int, int], stride: int = 1,
                     padding: Union[str, Sequence[int]] = "SAME",
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One prepared conv site of ``module`` on ``x`` → channels_last ``out_dtype``
    (float32, or the cast that follows it fused): its conv with the BN affine or
    bias folded into the dequant, before activation."""
    kernel_q = getattr(module, "kernel_q" + suffix, None)
    if kernel_q is None:
        raise RuntimeError(f"{type(module).__name__} site '{suffix or 'ConvBN'}' has no "
                           "int8 calibration: run quant.static.prepare_static_int8 first")
    in_absmax, deq, offset = (getattr(module, leaf + suffix)
                              for leaf in ("in_absmax", "deq", "offset"))
    return _int8_site_conv(x, kernel_q, in_absmax, deq, offset, kernel_size, stride, padding,
                           site_parts(module, suffix)[0].groups > 1, out_dtype)


def calibrate_directory(model: nn.Module, calib_dir: str, image_wh, max_images: int = 32,
                        margin: float = 1.0, per_channel: bool = False) -> nn.Module:
    """Calibrate over the images of ``calib_dir`` (letterboxed as serving inputs,
    the first ``max_images`` in name order) and prepare ``model``. Shared by
    ``serve --int8Static``."""
    from PIL import Image

    from tmv_tpu_torch.utils import image_helper

    paths = sorted(
        os.path.join(calib_dir, f) for f in os.listdir(calib_dir)
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    if not paths:
        raise ValueError(f"no calibration images in {calib_dir}")
    batches = []
    for p in paths[:max_images]:
        img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        boxed, _, _ = image_helper.proportional_resize(img, np.int32(image_wh), bg_color=(0, 0, 0))
        batches.append(boxed.astype(np.float32)[None] / 255.0)
    return prepare_static_int8(model, calibrate_model(model, batches), margin=margin,
                               per_channel=per_channel)
