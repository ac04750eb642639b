"""Fused depthwise conv + BatchNorm (folded) + swish: the CUDA kernel, its wrapper
and its plain version.

Replaces the Pallas TPU kernels ``tmv_tpu/kernels/dwconv_pallas.py::_fused_s1``
(body ``_dw_kernel_s1_folded``) and ``::_fused_s2`` (body ``_dw_kernel_s2_whole``),
which ``tmv_tpu/models/efficientdet/backbone.py::MBConvBlock`` calls for the eval
depthwise step of every MBConv block. One kernel covers both strides; its source
is ``tmv_tpu_torch/csrc/dwconv_bn_swish.cu``, whose header says what bounds it on
the H100 (device-memory bytes) and what the design does about it: a halo tile
staged in shared memory by double-buffered ``cp.async`` in persistent blocks, and
a sliding window in registers over each thread's 2 x 4 output pixels.

- ``fused_dw_bn_swish`` is the wrapper the port calls. It checks its inputs on
  every device, then a CUDA tensor launches the kernel or raises, and a CPU
  tensor runs ``dw_bn_swish_reference``. There is no other route and no switch.
- ``dw_bn_swish_reference`` is the plain PyTorch version, the counterpart of
  ``dwconv_pallas.py::dw_reference``: a grouped ``F.conv2d`` in float32 on the
  explicitly TF-SAME-padded input, then ``· scale + offset``, then
  ``y · sigmoid(y)``, cast to the input's dtype.
- ``LIBRARY`` builds the source with ``nvcc`` at first use (``kernels/build.py``).
- ``launches`` counts kernel launches.
- ``tmv::dw_bn_swish`` (``dw_bn_swish_op``) is the same function as a ``torch.library``
  custom op: the kernel's launch is its CUDA implementation, the plain version its CPU one,
  and its fake returns the channels_last output. ``fused_dw_bn_swish`` calls it while
  ``torch.export`` traces (an exported program carries the op, which picks by
  device when the program runs); eager calls go straight to the same functions.
- ``kernel_info`` reports what each instantiation uses on the card (registers,
  shared memory, spills, resident blocks per SM).

Layout: activations are channels_last ``(B, C, H, W)`` tensors (physically NHWC,
as the port's models keep them), float32 or bfloat16; taps are ``(k, k, C)``
float32 (the JAX package's layout, the flax ``(k, k, 1, C)`` kernel squeezed),
``scale`` and ``offset`` ``(C,)`` float32 (``γ / sqrt(var + eps)`` and
``β − mean · scale``). k is 3 or 5 and the stride 1 or 2; the result is a
channels_last tensor in the input's dtype.
"""

import ctypes
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from tmv_tpu_torch.kernels.build import SM90A_FLAGS, KernelLibrary, register_cuda_kernel
from tmv_tpu_torch.ops.padding import same_pads

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dwconv_bn_swish.cu"


def _bind(lib: ctypes.CDLL):
    lib.tmv_dw_bn_swish.restype = ctypes.c_int
    lib.tmv_dw_bn_swish.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.tmv_dw_bn_swish_info.restype = ctypes.c_int
    lib.tmv_dw_bn_swish_info.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]


LIBRARY = KernelLibrary(SOURCE, SM90A_FLAGS, _bind)
launches = 0
_lock = threading.Lock()


def _row_pads(x, k, stride, row_pads):
    return same_pads(x.shape[2], k, stride) if row_pads is None else tuple(row_pads)


def dw_bn_swish_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                          offset: torch.Tensor, stride: int = 1, row_pads=None) -> torch.Tensor:
    """Plain PyTorch ``swish(depthwise_conv(x, w, stride, SAME) · scale + offset)``;
    ``row_pads`` (top, bottom) replace the TF-SAME row pads (a halo-padded shard's)."""
    c, k = x.shape[1], w.shape[0]
    top, bottom = _row_pads(x, k, stride, row_pads)
    left, right = same_pads(x.shape[3], k, stride)
    xp = F.pad(x.float(), (left, right, top, bottom))
    y = F.conv2d(xp, w.float().permute(2, 0, 1).unsqueeze(1), stride=stride, groups=c)
    y = y * scale.float().view(1, c, 1, 1) + offset.float().view(1, c, 1, 1)
    return (y * torch.sigmoid(y)).to(x.dtype).contiguous(memory_format=torch.channels_last)


def _check(x, w, scale, offset, stride, layout=True):
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_dw_bn_swish: x must be a 4-d float32 or bfloat16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if layout and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_dw_bn_swish: x must be channels_last-contiguous (B, C, H, W)")
    c, k = x.shape[1], w.shape[0]
    if k not in (3, 5) or tuple(w.shape) != (k, k, c):
        raise ValueError(f"fused_dw_bn_swish: taps must be (k, k, {c}) with k in (3, 5), "
                         f"got {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"fused_dw_bn_swish: stride must be 1 or 2, got {stride}")
    for name, t, shape in (("taps", w, (k, k, c)), ("scale", scale, (c,)),
                           ("offset", offset, (c,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_dw_bn_swish: {name} must be contiguous float32 {shape}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_dw_bn_swish: {name} is on {t.device}, x on {x.device}")


def _out_like(x, k, stride, row_pads=None):
    b, c, h, w = x.shape
    top, bottom = _row_pads(x, k, stride, row_pads)
    return torch.empty((b, c, (h + top + bottom - k) // stride + 1, -(-w // stride)),
                       dtype=x.dtype, device=x.device, memory_format=torch.channels_last)


def _dw_cuda(x, w, scale, offset, stride, row_pads=None):
    """The kernel's launch (``tmv::dw_bn_swish``'s CUDA implementation). In a traced
    program the layout is the run's, not the trace's: a tensor that arrives in
    another layout is made channels_last here (a no-op where it is). With
    ``row_pads`` the kernel's top pad and output rows are a halo-padded shard's (the
    rows past the input's last read as zeros, as the kernel reads every border)."""
    x = x.contiguous(memory_format=torch.channels_last)
    b, c, h, width = x.shape
    k = w.shape[0]
    top, left = _row_pads(x, k, stride, row_pads)[0], same_pads(width, k, stride)[0]
    out = _out_like(x, k, stride, row_pads)
    if out.numel() == 0:
        return out
    # 4-channel-aligned rows and pointers: the halo is staged by cp.async; else
    # element by element
    vector_ok = (c % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
                 and all(t.data_ptr() % 16 == 0 for t in (w, scale, offset)))
    lib = LIBRARY.load()
    # the device made current and its current stream taken by C calls, without a
    # torch.cuda.Stream object: this host work is on every b1 forward's path
    index = x.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_dw_bn_swish(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), offset.data_ptr(), out.data_ptr(),
        b, h, width, c, out.shape[2], out.shape[3], top, left, k, stride,
        int(x.dtype == torch.bfloat16), 4 if vector_ok else 1,
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_dw_bn_swish")
    global launches
    with _lock:
        launches += 1
    return out


@torch.library.custom_op("tmv::dw_bn_swish", mutates_args=(), device_types="cpu")
def dw_bn_swish_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, stride: int) -> torch.Tensor:
    """``fused_dw_bn_swish`` as an op; on the CPU the plain version."""
    return dw_bn_swish_reference(x, w, scale, offset, stride)


register_cuda_kernel(dw_bn_swish_op, _dw_cuda)


@dw_bn_swish_op.register_fake
def _dw_fake(x, w, scale, offset, stride):
    return _out_like(x, w.shape[0], stride)


def fused_dw_bn_swish(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor, stride: int = 1, row_pads=None) -> torch.Tensor:
    """``swish(depthwise_conv(x, w, stride, SAME) · scale + offset)``; the CUDA
    kernel for CUDA tensors. Does not synchronise. ``row_pads`` (top, bottom) replace
    the TF-SAME row pads: the rows of a height-sharded forward's shard, its halo
    included (``parallel.halo.window_rows``); the columns stay TF-SAME."""
    exporting = torch.compiler.is_exporting()
    # traced on the card, the swish after an eval BatchNorm carries contiguous
    # strides where the run gives channels_last; the CUDA implementation takes either
    _check(x, w, scale, offset, stride, layout=not exporting)
    if row_pads is not None and (exporting or min(row_pads) < 0):
        raise ValueError(f"fused_dw_bn_swish: row pads {row_pads} (exported programs take "
                         "TF-SAME pads only)")
    if exporting:
        return dw_bn_swish_op(x, w, scale, offset, stride)
    if x.device.type == "cpu":
        return dw_bn_swish_reference(x, w, scale, offset, stride, row_pads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dw_bn_swish: no kernel for device {x.device}")
    return _dw_cuda(x, w, scale, offset, stride, row_pads)


def kernel_info(k: int, stride: int, dtype: torch.dtype) -> dict:
    """What the kernel instantiated for ``(k, stride, dtype)`` uses on the
    current card: registers per thread, shared memory per block (bytes, the
    double buffer included), spilled bytes per thread, resident blocks per SM
    and threads per block."""
    lib = LIBRARY.load()
    out = (ctypes.c_int * 5)()
    LIBRARY.check(lib.tmv_dw_bn_swish_info(k, stride, int(dtype == torch.bfloat16), out),
                  "tmv_dw_bn_swish_info")
    return dict(zip(("registers", "smem_bytes", "spill_bytes", "blocks_per_sm", "threads"),
                    out))
