"""int8 × int8 → int32 convolutions: the CUDA kernels, their wrappers, their plain
versions and the route planners.

Replaces XLA's int8 ``conv_general_dilated(..., preferred_element_type=int32)`` of
``tmv_tpu/quant/static.py::static_int8_conv`` (``:212``) and
``tmv_tpu/quant/dynamic.py::dynamic_int8_conv`` (``:85``); the JAX package has no
Pallas kernel there, and PyTorch has no int8 convolution on CUDA. The source is
``tmv_tpu_torch/csrc/int8_conv.cu``, whose header says what bounds each kernel on the
H100 and what its design does about it. For an output pixel and channel ``o``::

    xq  = clip(rint(x · (127 / a)), −127, 127)          (a: per-tensor or per-channel)
    acc = Σ_taps Σ_c xq · kernel_q                     (int32, exact)
    out = float(acc) · deq[o] + offset[o]              (float32, NHWC)

``out_dtype=torch.bfloat16`` rounds the float32 result to bfloat16 in the kernel's
epilogue: the cast a bf16 model applies next, fused (the same numbers, half the
bytes written and one pass fewer).

- ``int8_conv`` (groups 1, the Darknet ConvBNs and D0's dense sites; on the card a
  quantize pass into int8 NHWC, then a ``wgmma`` implicit GEMM) and ``int8_dwconv``
  (groups = C, D0's depthwise sites; a halo-tiled kernel that quantises its staged
  tile once) are the wrappers the port calls.
  Each checks its inputs on every device, then a CUDA tensor launches the kernel or
  raises, and a CPU tensor runs the plain version. There is no other route and no
  switch. ``return_acc=True`` returns the int32 accumulator instead (a test entry).
- ``int8_conv_reference`` and ``int8_dwconv_reference`` are the plain versions: the
  same ``xq``, exact integer sums through a float64 ``F.conv2d`` of the int8 values
  (|acc| < 2⁵³), then the same float32 epilogue (multiply, then add).
- ``LIBRARY`` builds the source with ``nvcc`` at first use (``kernels/build.py``).
- ``launches`` counts the wrappers' calls that reached the card, by name (an ``int8_conv``
  call is two launches: the quantize pass and the GEMM).
- ``tmv::int8_conv`` (``int8_conv_op``: the quantize pass and the GEMM in one op) and
  ``tmv::int8_dwconv`` (``int8_dwconv_op``) are the two wrappers as ``torch.library``
  custom ops: the kernels' launches are their CUDA implementations, the plain versions their
  CPU ones, and their fakes return the channels_last output. The wrappers call them
  while ``torch.export`` traces, so that an exported program carries the ops and picks
  by device when it runs; eager calls go straight to the same functions. Alignment
  checks and the weight maps' cache live in the CUDA implementations (a fake tensor
  has no address).
- ``kernel_info`` reports what each kernel instantiation uses on the card.
- ``quantize_padded`` is the first of ``int8_conv``'s two launches on its own (the
  quantize pass into int8 NHWC with the channels padded to 16), for timing it apart;
  ``quantize_padded_reference`` is its plain version.
- ``conv_plan`` and ``dw_plan`` are the route planners: what the kernels are given
  (padded channels, K, the tile width) for a conv's shape, or a refusal.

Layouts: activations are channels_last ``(B, C, H, W)`` tensors, float32 or bfloat16.
``kernel_q`` is int8, for ``int8_conv`` ``(Cout, Kpad)``: row ``o`` holds the weights
in ``(dy, dx, c)`` order over ``Cp`` channels, ``Cin`` padded with zeros to a multiple
of 16 (``K = kh·kw·Cp``), then padded with zeros to a multiple of 64 (``pack_dense``):
the layout of the kernel's B operand, K-major, one 16-byte chunk a tap's 16 channels;
for ``int8_dwconv`` ``(k·k, C)`` (``pack_depthwise``). ``in_absmax`` is a 0-d float32
tensor or a ``(Cin,)`` vector; ``deq`` and ``offset`` are ``(Cout,)`` float32
(``offset`` may be None). ``pads`` are ``(top, left, bottom, right)`` zero pads.
"""

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tmv_tpu_torch.kernels.build import SM90A_FLAGS, KernelLibrary, register_cuda_kernel

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "int8_conv.cu"
K_TILE = 64          # bytes of K per shared-memory stage of the GEMM
CHANNEL_ALIGN = 16   # channels of one 16-byte chunk of the quantised activation
BLOCK_NS = (32, 64, 128)
DW_ROUTES = {(3, 1), (3, 2), (5, 1), (5, 2)}   # (k, stride) of the depthwise kernel


def _bind(lib: ctypes.CDLL):
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.tmv_int8_quantize.restype = cint
    lib.tmv_int8_quantize.argtypes = [ptr, ptr, cint, ptr] + [cint] * 5 + [ptr]
    lib.tmv_int8_conv.restype = cint
    lib.tmv_int8_conv.argtypes = ([ptr, ptr, cint, ptr, ptr, ptr, cint] + [ptr] * 3
                                  + [cint] * 17 + [ptr])
    lib.tmv_int8_weight_map.restype = cint
    lib.tmv_int8_weight_map.argtypes = [ptr] + [cint] * 3 + [ptr]
    lib.tmv_int8_dwconv.restype = cint
    lib.tmv_int8_dwconv.argtypes = [ptr, ptr, cint] + [ptr] * 4 + [cint] * 13 + [ptr]
    lib.tmv_int8_kernel_info.restype = cint
    lib.tmv_int8_kernel_info.argtypes = [cint] * 4 + [ctypes.POINTER(cint)]


LIBRARY = KernelLibrary(SOURCE, SM90A_FLAGS, _bind)
launches = {"int8_conv": 0, "int8_dwconv": 0, "int8_quantize": 0}
_lock = threading.Lock()
# the weights' TMA maps, encoded once per packed weight tensor (its address, shape and
# tile width are all a map holds, so a key that matches gives a valid map)
_weight_maps = {}
_WEIGHT_MAPS_KEPT = 4096


def padded_channels(cin: int) -> int:
    """``Cin`` padded to a multiple of 16: the channels of the quantised activation."""
    return -(-cin // CHANNEL_ALIGN) * CHANNEL_ALIGN


def conv_plan(cin: int, cout: int, kh: int, kw: int) -> dict:
    """What ``int8_conv``'s kernels are given for a conv shape: ``cp`` padded
    channels, ``k`` = kh·kw·cp, ``kpad`` (a multiple of 64) and ``block_n``, the
    output channels of a block (32, 64 or 128: the narrowest that holds Cout, so
    that Cout = 32 and 64 fill their tile)."""
    if min(cin, cout, kh, kw) < 1:
        raise ValueError(f"int8_conv: no route for Cin {cin}, Cout {cout}, kernel {kh}x{kw}")
    cp = padded_channels(cin)
    k = kh * kw * cp
    return {"cp": cp, "k": k, "kpad": -(-k // K_TILE) * K_TILE,
            "block_n": next((n for n in BLOCK_NS if cout <= n), BLOCK_NS[-1])}


def dw_plan(k: int, stride: int) -> dict:
    """The ``int8_dwconv`` kernel's route for a kernel size and stride (k 3 or 5,
    stride 1 or 2: every depthwise site of EfficientDet), or a ValueError."""
    if (k, stride) not in DW_ROUTES:
        raise ValueError(f"int8_dwconv: the kernel takes k in {{3, 5}} and stride in "
                         f"{{1, 2}}, got k={k}, stride={stride}")
    return {"k": k, "stride": stride}


def pack_dense(kernel_q_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO int8 ``(kh, kw, Cin, Cout)`` → the kernel's ``(Cout, Kpad)``: Cin padded
    with zeros to ``Cp``, rows in ``(dy, dx, c)`` order, K padded to ``Kpad``."""
    kh, kw, cin, cout = kernel_q_hwio.shape
    plan = conv_plan(cin, cout, kh, kw)
    rows = F.pad(kernel_q_hwio, (0, 0, 0, plan["cp"] - cin))
    rows = rows.permute(3, 0, 1, 2).reshape(cout, plan["k"])
    return F.pad(rows, (0, plan["kpad"] - plan["k"])).contiguous()


def unpack_dense(packed: torch.Tensor, kh: int, kw: int, cin: int) -> torch.Tensor:
    """The kernel's ``(Cout, Kpad)`` → HWIO ``(kh, kw, Cin, Cout)``."""
    cp = padded_channels(cin)
    rows = packed[:, :kh * kw * cp].reshape(-1, kh, kw, cp)
    return rows[..., :cin].permute(1, 2, 3, 0)


def pack_depthwise(kernel_q_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO int8 ``(k, k, 1, C)`` → the kernel's ``(k·k, C)``."""
    k1, k2, one, c = kernel_q_hwio.shape
    assert one == 1, kernel_q_hwio.shape
    return kernel_q_hwio.reshape(k1 * k2, c).contiguous()


def true_div(num, den) -> torch.Tensor:
    """Elementwise IEEE division where one side may be a Python number. PyTorch's
    ``number / tensor`` is ``tensor.reciprocal() * number``, and its CUDA division by
    a scalar multiplies by the scalar's reciprocal; either can differ from XLA's
    division by an ulp, which flips a rounding now and then. A full tensor on each
    side keeps the division a division."""
    like = num if torch.is_tensor(num) else den
    num = num if torch.is_tensor(num) else torch.full_like(like, num)
    den = den if torch.is_tensor(den) else torch.full_like(like, den)
    return num / den


def quantize_reference(x: torch.Tensor, in_absmax: torch.Tensor) -> torch.Tensor:
    """``clip(rint(x · (127 / a)), −127, 127)`` as int8, ``a`` per tensor or per channel."""
    scale = true_div(127.0, in_absmax.float())
    if scale.dim():
        scale = scale.view(1, -1, 1, 1)
    return torch.clamp(torch.round(x.float() * scale), -127, 127).to(torch.int8)


def quantize_padded_reference(x: torch.Tensor, in_absmax: torch.Tensor) -> torch.Tensor:
    """Plain version of ``quantize_padded``: ``quantize_reference`` as int8 NHWC
    ``(B, H, W, Cp)``, zeros in the channels past Cin."""
    xq = quantize_reference(x, in_absmax).permute(0, 2, 3, 1)
    return F.pad(xq, (0, padded_channels(x.shape[1]) - x.shape[1])).contiguous()


def _epilogue(acc: torch.Tensor, deq: torch.Tensor, offset: Optional[torch.Tensor],
              out_dtype: torch.dtype):
    y = acc.float() * deq.view(1, -1, 1, 1)
    if offset is not None:
        y = y + offset.view(1, -1, 1, 1)
    return y.to(out_dtype).contiguous(memory_format=torch.channels_last)


def _reference(x, kernel_oihw, in_absmax, deq, offset, stride, pads, groups, return_acc,
               out_dtype):
    top, left, bottom, right = pads
    xq = F.pad(quantize_reference(x, in_absmax).double(), (left, right, top, bottom))
    acc = F.conv2d(xq, kernel_oihw.double(), stride=stride, groups=groups).to(torch.int32)
    if return_acc:
        return acc.contiguous(memory_format=torch.channels_last)
    return _epilogue(acc, deq, offset, out_dtype)


def int8_conv_reference(x, kernel_q, in_absmax, deq, offset, kernel_size: Tuple[int, int],
                        stride: int = 1, pads: Sequence[int] = (0, 0, 0, 0),
                        return_acc: bool = False,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``int8_conv``."""
    kh, kw = kernel_size
    weight = unpack_dense(kernel_q, kh, kw, x.shape[1]).permute(3, 2, 0, 1)
    return _reference(x, weight, in_absmax, deq, offset, stride, pads, 1, return_acc, out_dtype)


def int8_dwconv_reference(x, kernel_q, in_absmax, deq, offset, k: int, stride: int = 1,
                          pads: Sequence[int] = (0, 0, 0, 0), return_acc: bool = False,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``int8_dwconv``."""
    c = x.shape[1]
    weight = kernel_q.t().reshape(c, 1, k, k)
    return _reference(x, weight, in_absmax, deq, offset, stride, pads, c, return_acc, out_dtype)


def _out_size(size: int, k: int, stride: int, before: int, after: int) -> int:
    return (size + before + after - k) // stride + 1


def _check(name, x, kernel_q, kq_shape, in_absmax, deq, offset, cout, stride, pads, out_dtype):
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be a 4-d float32 or bfloat16 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be channels_last-contiguous (B, C, H, W)")
    if (kernel_q.dtype != torch.int8 or tuple(kernel_q.shape) != kq_shape
            or not kernel_q.is_contiguous()):
        raise ValueError(f"{name}: kernel_q must be contiguous int8 {kq_shape}, "
                         f"got {tuple(kernel_q.shape)} {kernel_q.dtype}")
    cin = x.shape[1]
    if in_absmax.dtype != torch.float32 or tuple(in_absmax.shape) not in ((), (cin,)):
        raise ValueError(f"{name}: in_absmax must be float32 () or ({cin},), got "
                         f"{tuple(in_absmax.shape)} {in_absmax.dtype}")
    for what, t in (("deq", deq), ("offset", offset)):
        if t is None and what == "offset":
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,) or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 ({cout},), got "
                             f"{tuple(t.shape)} {t.dtype}")
    for what, t in (("kernel_q", kernel_q), ("in_absmax", in_absmax), ("deq", deq),
                    ("offset", offset)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
    if stride < 1 or len(pads) != 4 or min(pads) < 0:
        raise ValueError(f"{name}: stride {stride}, pads {pads}")


def _count(name: str):
    with _lock:
        launches[name] += 1


def _library_for(x):
    if x.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x.device}")
    return LIBRARY.load()


def _vec(x: torch.Tensor, channels: int) -> bool:
    """Whether ``x``'s rows take the kernels' vector loads: a multiple of
    ``channels`` channels and a 16-byte aligned start."""
    return x.shape[1] % channels == 0 and x.data_ptr() % 16 == 0


def quantize_padded(x: torch.Tensor, in_absmax: torch.Tensor) -> torch.Tensor:
    """``int8_conv``'s quantize pass alone: ``x`` → int8 NHWC ``(B, H, W, Cp)``; the
    CUDA kernel for CUDA tensors. Does not synchronise."""
    b, cin, h, w = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError("quantize_padded: x must be channels_last float32 or bfloat16")
    if x.device.type == "cpu":
        return quantize_padded_reference(x, in_absmax)
    cp = padded_channels(cin)
    xq = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    lib = _library_for(x)
    # the device made current and its current stream taken by C calls, without a
    # torch.cuda.Stream object: this host work is on every b1 forward's path
    index = x.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_int8_quantize(x.data_ptr(), in_absmax.data_ptr(), int(in_absmax.dim() == 1),
                                xq.data_ptr(), b * h * w, cin, cp, int(x.dtype == torch.bfloat16),
                                int(_vec(x, 8)),
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_int8_quantize")
    _count("int8_quantize")
    return xq


def _weight_map(lib, kernel_q: torch.Tensor, kpad: int, block_n: int):
    """The 128-byte TMA map of ``kernel_q`` for ``block_n``-row tiles, from the cache
    or encoded now."""
    key = (kernel_q.device.index, kernel_q.data_ptr(), kernel_q.shape[0], kpad, block_n)
    with _lock:
        found = _weight_maps.get(key)
    if found is None:
        found = (ctypes.c_ubyte * 128)()
        LIBRARY.check(lib.tmv_int8_weight_map(kernel_q.data_ptr(), kernel_q.shape[0], kpad,
                                              block_n, found), "tmv_int8_weight_map")
        with _lock:
            if len(_weight_maps) >= _WEIGHT_MAPS_KEPT:
                _weight_maps.clear()
            _weight_maps[key] = found
    return found


def _out_shape(x, cout, kh, kw, stride, pads):
    top, left, bottom, right = pads
    return (x.shape[0], cout, _out_size(x.shape[2], kh, stride, top, bottom),
            _out_size(x.shape[3], kw, stride, left, right))


def _empty_out(x, shape, return_acc, out_dtype):
    return torch.empty(shape, dtype=torch.int32 if return_acc else out_dtype, device=x.device,
                       memory_format=torch.channels_last)


def _conv_cuda(x, kernel_q, in_absmax, deq, offset, kh, kw, stride, pads, return_acc,
               out_dtype):
    """The quantize pass and the GEMM (``tmv::int8_conv``'s CUDA implementation)."""
    b, cin, h, w = x.shape
    cout = kernel_q.shape[0]
    plan = conv_plan(cin, cout, kh, kw)
    top, left = pads[0], pads[1]
    out = _empty_out(x, _out_shape(x, cout, kh, kw, stride, pads), return_acc, out_dtype)
    if out.numel() == 0:
        return out
    if kernel_q.data_ptr() % 16:
        raise ValueError("int8_conv: kernel_q must be 16-byte aligned")
    xq = torch.empty((b, h, w, plan["cp"]), dtype=torch.int8, device=x.device)
    out_kind = 2 if return_acc else int(out_dtype == torch.bfloat16)
    lib = _library_for(x)
    weight_map = _weight_map(lib, kernel_q, plan["kpad"], plan["block_n"])
    index = x.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_int8_conv(
        x.data_ptr(), in_absmax.data_ptr(), int(in_absmax.dim() == 1), xq.data_ptr(),
        kernel_q.data_ptr(), weight_map, plan["kpad"], deq.data_ptr(),
        None if offset is None else offset.data_ptr(), out.data_ptr(), out_kind,
        b, h, w, cin, plan["cp"], cout, kh, kw, stride, top, left, out.shape[2],
        out.shape[3], plan["block_n"], int(x.dtype == torch.bfloat16), int(_vec(x, 8)),
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_int8_conv")
    _count("int8_conv")
    return out


@torch.library.custom_op("tmv::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv_op(x: torch.Tensor, kernel_q: torch.Tensor, in_absmax: torch.Tensor,
                 deq: torch.Tensor, offset: Optional[torch.Tensor], kh: int, kw: int,
                 stride: int, pads: List[int], return_acc: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``int8_conv`` as an op; on the CPU the plain version."""
    return int8_conv_reference(x, kernel_q, in_absmax, deq, offset, (kh, kw), stride, pads,
                               return_acc, out_dtype)


register_cuda_kernel(int8_conv_op, _conv_cuda)


@int8_conv_op.register_fake
def _conv_fake(x, kernel_q, in_absmax, deq, offset, kh, kw, stride, pads, return_acc,
               out_dtype):
    return _empty_out(x, _out_shape(x, kernel_q.shape[0], kh, kw, stride, pads), return_acc,
                      out_dtype)


def int8_conv(x: torch.Tensor, kernel_q: torch.Tensor, in_absmax: torch.Tensor,
              deq: torch.Tensor, offset: Optional[torch.Tensor], kernel_size: Tuple[int, int],
              stride: int = 1, pads: Sequence[int] = (0, 0, 0, 0),
              return_acc: bool = False, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense int8 conv (groups 1) → ``out_dtype`` channels_last ``(B, Cout, Ho, Wo)``
    (or its int32 accumulator); for CUDA tensors the quantize pass and the GEMM kernel
    (one call, counted once). Does not synchronise."""
    kh, kw = kernel_size
    cout = kernel_q.shape[0]
    plan = conv_plan(x.shape[1], cout, kh, kw)
    _check("int8_conv", x, kernel_q, (cout, plan["kpad"]), in_absmax, deq, offset, cout, stride,
           pads, out_dtype)
    args = (x, kernel_q, in_absmax, deq, offset, kh, kw, stride, [int(p) for p in pads],
            return_acc, out_dtype)
    if torch.compiler.is_exporting():
        return int8_conv_op(*args)
    if x.device.type == "cpu":
        return int8_conv_reference(x, kernel_q, in_absmax, deq, offset, kernel_size, stride,
                                   pads, return_acc, out_dtype)
    return _conv_cuda(*args)


def _dwconv_cuda(x, kernel_q, in_absmax, deq, offset, k, stride, pads, return_acc, out_dtype):
    """The halo-tiled kernel (``tmv::int8_dwconv``'s CUDA implementation)."""
    b, c, h, w = x.shape
    top, left = pads[0], pads[1]
    out = _empty_out(x, _out_shape(x, c, k, k, stride, pads), return_acc, out_dtype)
    if out.numel() == 0:
        return out
    dw_plan(k, stride)
    vec = c % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
    out_kind = 2 if return_acc else int(out_dtype == torch.bfloat16)
    lib = _library_for(x)
    index = x.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_int8_dwconv(
        x.data_ptr(), in_absmax.data_ptr(), int(in_absmax.dim() == 1), kernel_q.data_ptr(),
        deq.data_ptr(), None if offset is None else offset.data_ptr(), out.data_ptr(),
        out_kind, b, h, w, c, k, stride, top, left, out.shape[2], out.shape[3],
        int(x.dtype == torch.bfloat16), int(vec),
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_int8_dwconv")
    _count("int8_dwconv")
    return out


@torch.library.custom_op("tmv::int8_dwconv", mutates_args=(), device_types="cpu")
def int8_dwconv_op(x: torch.Tensor, kernel_q: torch.Tensor, in_absmax: torch.Tensor,
                   deq: torch.Tensor, offset: Optional[torch.Tensor], k: int, stride: int,
                   pads: List[int], return_acc: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """``int8_dwconv`` as an op; on the CPU the plain version."""
    return int8_dwconv_reference(x, kernel_q, in_absmax, deq, offset, k, stride, pads,
                                 return_acc, out_dtype)


register_cuda_kernel(int8_dwconv_op, _dwconv_cuda)


@int8_dwconv_op.register_fake
def _dwconv_fake(x, kernel_q, in_absmax, deq, offset, k, stride, pads, return_acc, out_dtype):
    return _empty_out(x, _out_shape(x, x.shape[1], k, k, stride, pads), return_acc, out_dtype)


def int8_dwconv(x: torch.Tensor, kernel_q: torch.Tensor, in_absmax: torch.Tensor,
                deq: torch.Tensor, offset: Optional[torch.Tensor], k: int, stride: int = 1,
                pads: Sequence[int] = (0, 0, 0, 0), return_acc: bool = False,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Depthwise int8 conv (groups = C) → ``out_dtype`` channels_last ``(B, C, Ho,
    Wo)`` (or its int32 accumulator); the CUDA kernel for CUDA tensors. Does not
    synchronise."""
    c = x.shape[1]
    _check("int8_dwconv", x, kernel_q, (k * k, c), in_absmax, deq, offset, c, stride, pads,
           out_dtype)
    args = (x, kernel_q, in_absmax, deq, offset, k, stride, [int(p) for p in pads], return_acc,
            out_dtype)
    if torch.compiler.is_exporting():
        return int8_dwconv_op(*args)
    if x.device.type == "cpu":
        return int8_dwconv_reference(x, kernel_q, in_absmax, deq, offset, k, stride, pads,
                                     return_acc, out_dtype)
    return _dwconv_cuda(*args)


def kernel_info(kind: str, block_n: int = 64, dtype: torch.dtype = torch.bfloat16,
                k: int = 3, stride: int = 1) -> dict:
    """What an instantiation uses on the current card: registers per thread, shared
    memory per block (bytes, dynamic included), spilled bytes per thread, resident
    blocks per SM and threads per block. ``kind`` "gemm" (``block_n`` 32, 64 or 128),
    "quantize" (``dtype`` activations) or "dwconv" (``dtype``, ``k``, ``stride``)."""
    lib = LIBRARY.load()
    out = (ctypes.c_int * 5)()
    args = {"gemm": (0, block_n, 0, 0), "quantize": (1, int(dtype == torch.bfloat16), 0, 0),
            "dwconv": (2, int(dtype == torch.bfloat16), k, stride)}[kind]
    LIBRARY.check(lib.tmv_int8_kernel_info(*args, out), "tmv_int8_kernel_info")
    return dict(zip(("registers", "smem_bytes", "spill_bytes", "blocks_per_sm", "threads"), out))
