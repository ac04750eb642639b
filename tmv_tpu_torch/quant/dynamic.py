"""Dynamic int8 quantization for the serving path.

Port of ``tmv_tpu/quant/dynamic.py``. Symmetric dynamic quantization, no
calibration pass:

- weights: per-output-channel absmax int8, quantised at each call (folded with the
  BN affine in the dequant);
- activations: one per-tensor absmax, computed on the card from the live tensor
  (one reduction, handed to the kernel as a device pointer: no host sync);
- accumulation: int32 on the int8 tensor cores (``kernels/int8_conv.py``); dequant
  and the BN offset in float32, the activation after the caller's cast.

A serving mode: training and the default predict path stay in bf16/f32. The mode is
a thread-local context read at forward time (``quant_mode()``), entered by the
predictors around the forward (``quantized(mode)``), so a predictor run on the
micro-batcher's thread sets it there. Modes: ``"off"``, ``"int8"`` (dynamic),
``"int8_static"`` (``quant/static.py``) and ``"calib"`` (record activation ranges).
"""

import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple, Union

import torch

from tmv_tpu_torch.kernels.int8_conv import int8_conv, pack_dense, true_div
from tmv_tpu_torch.ops.padding import same_pads
from tmv_tpu_torch.parallel import halo

_STATE = threading.local()


def quant_mode() -> str:
    """Forward-time quantization mode of this thread: "off" (default), "int8",
    "int8_static" or "calib"."""
    return getattr(_STATE, "mode", "off")


@contextmanager
def quantized(mode: str = "int8"):
    """Run the enclosed forwards with the quantized conv sites of ``mode``."""
    prev = quant_mode()
    _STATE.mode = mode
    try:
        yield
    finally:
        _STATE.mode = prev


def conv_pads(size_hw: Tuple[int, int], kernel_size: Tuple[int, int], stride: int,
              padding: Union[str, Sequence[int]]) -> Tuple[int, int, int, int]:
    """(top, left, bottom, right) zero pads of ``padding``: "SAME" (TF-SAME),
    "VALID", or the four pads themselves."""
    if not isinstance(padding, str):
        return tuple(int(p) for p in padding)
    if padding == "VALID":
        return (0, 0, 0, 0)
    (top, bottom), (left, right) = (same_pads(size_hw[0], kernel_size[0], stride),
                                    same_pads(size_hw[1], kernel_size[1], stride))
    return (top, left, bottom, right)


def shard_conv_input(x: torch.Tensor, kernel_size: Tuple[int, int], stride: int,
                     padding: Union[str, Sequence[int]]):
    """``(x, pads)``: ``x`` and its ``conv_pads``; in a height-sharded forward the pads of
    the global image, and this shard's input rows with their halo and the row pads
    left at the image's edges (``parallel.halo.window_rows``)."""
    top, left, bottom, right = conv_pads((halo.global_height(x), x.shape[3]), kernel_size,
                                         stride, padding)
    x, top, bottom = halo.window_rows(x, kernel_size[0], stride, top, bottom)
    return x, (top, left, bottom, right)


def dynamic_int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                      padding: Union[str, Sequence[int]] = "SAME",
                      out_scale: Optional[torch.Tensor] = None,
                      out_offset: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8×int8→int32 convolution with dynamic activation quantization.

    ``x``: channels_last ``(B, Cin, H, W)`` float activations; ``weight``: ``(Cout,
    Cin, kh, kw)`` float weights; ``out_scale`` / ``out_offset``: optional ``(Cout,)``
    multiplier folded into the dequant and term added after it (the BN affine).
    Returns the channels_last output in float32, or rounded to ``out_dtype`` in
    the kernel (the caller's cast, fused); the caller activates. In a height-sharded
    forward the absmax is the whole image's (the shards' maximum)."""
    a_max = torch.clamp_min(halo.space_max(
        torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32), x), 1e-6)
    kh, kw = weight.shape[2:]
    x, pads = shard_conv_input(x, (kh, kw), stride, padding)
    x = x.contiguous(memory_format=torch.channels_last)
    kf = weight.float()
    w_max = torch.clamp_min(kf.abs().amax(dim=(1, 2, 3)), 1e-12)
    wq = torch.clamp(torch.round(kf * true_div(127.0, w_max).view(-1, 1, 1, 1)), -127, 127
                     ).to(torch.int8)
    deq = true_div(a_max, 127.0) * true_div(w_max, 127.0)
    if out_scale is not None:
        deq = deq * out_scale.float()
    offset = None if out_offset is None else out_offset.float().contiguous()
    return int8_conv(x, pack_dense(wq.permute(2, 3, 1, 0)), a_max, deq.contiguous(), offset,
                     (kh, kw), stride, pads, out_dtype=out_dtype)
