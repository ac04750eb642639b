"""Greedy NMS suppression sweep: the CUDA kernel, its wrapper and its plain version.

Replaces the Pallas TPU kernel ``tmv_tpu/kernels/nms_pallas.py::greedy_sweep_pallas``
(body ``_sweep_kernel``), which ``tmv_tpu/ops/nms.py::_greedy_nms`` calls for the
suppression loop of both detectors' predict paths. The kernel source is
``tmv_tpu_torch/csrc/nms_sweep.cu``; its header says what bounds it on the H100
(latency: greedy order is sequential) and what the design does about it. A
sweep is two launches on one stream: the mask kernel writes a packed
suppression bitmask over the upper triangle of the N x N pair matrix, and the
scan kernel (one warp per image) walks it 64 candidates at a time.

- ``greedy_sweep`` is the wrapper the port calls. A CUDA tensor launches the
  kernel or raises; a CPU tensor runs ``greedy_sweep_reference``. There is no
  other route and no switch.
- ``greedy_sweep_reference`` is the plain PyTorch version: the sequential loop of
  ``tmv_tpu/ops/nms.py:104-119``, vectorised over the leading image axis. The CPU
  tests and the comparison on the card call it by name.
- ``suppression_mask_reference`` and ``scan_reference`` are the plain versions of
  the two stages; ``scan_reference(suppression_mask_reference(...))`` equals the
  sweep. ``suppression_mask`` and ``scan`` launch one stage each on the card, for
  the card tests and for timing the stages apart.
- ``LIBRARY`` builds the source with ``nvcc`` at first use (``kernels/build.py``)
  and loads it through ``ctypes``.
- ``launches`` counts sweeps launched by ``greedy_sweep`` (each two kernel
  launches), so that a run can show that its main path went through the kernel.
  The stage helpers do not count: the main path never calls them.
- ``tmv::nms_sweep`` (``nms_sweep_op``) is the sweep as a ``torch.library`` custom op: its
  CUDA implementation is the kernel's launch (counted), its CPU implementation the
  plain version, its fake the ``(B, N)`` bool shape. ``greedy_sweep`` calls it
  while ``torch.export`` traces, so that an exported program carries the op and
  picks the kernel or the plain version by the device it runs on; eager calls
  skip the dispatcher's host cost and go straight to the same two functions.

The mask is ``(B, N, ceil(N / 64))`` int64 words holding the kernel's uint64 bits:
bit ``j % 64`` of word ``j // 64`` of row ``i`` is set iff ``j > i``, the pair's IoU
is at or above the threshold and, class-aware, the classes are equal. Only the
words from ``i // 64`` on are defined (``upper_words``); the kernel leaves the others
unwritten and nothing reads them.
"""

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from tmv_tpu_torch.kernels.build import SM90A_FLAGS, KernelLibrary, register_cuda_kernel
from tmv_tpu_torch.ops.iou import iou_xyxy, iou_yxyx

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nms_sweep.cu"
WORD = 64
# The scan kernel keeps an image's removed words and eligible flags in shared
# memory, sized for 192 words of 64 candidates (csrc/nms_sweep.cu MAX_WORDS).
MAX_CANDIDATES = 192 * WORD

_VARIANTS = {("xyxy", "iou"): 0, ("xyxy", "diou"): 1,
             ("yxyx", "iou"): 2, ("yxyx", "diou"): 3}


def _bind(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tmv_nms_sweep.restype = i
    lib.tmv_nms_sweep.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, p]
    lib.tmv_nms_mask.restype = i
    lib.tmv_nms_mask.argtypes = [p, p, p, i, i, ctypes.c_float, i, p]
    lib.tmv_nms_scan.restype = i
    lib.tmv_nms_scan.argtypes = [p, p, p, i, i, p]


# -fmad=false: every product and sum rounds as in the plain version, so the
# kept sets compare exactly.
LIBRARY = KernelLibrary(SOURCE, SM90A_FLAGS + ["-fmad=false"], _bind)
launches = 0
_lock = threading.Lock()


def _iou_fn(coord: str):
    if coord == "xyxy":
        return iou_xyxy
    if coord == "yxyx":
        return iou_yxyx
    raise ValueError(f"unknown coord convention {coord!r}")


def mask_words(n: int) -> int:
    """Words of 64 candidates per mask row."""
    return -(-n // WORD)


def upper_words(n: int, device=None) -> torch.Tensor:
    """``(N, ceil(N / 64))`` bool: the mask words the kernel defines."""
    rows = torch.arange(n, device=device)[:, None] // WORD
    return torch.arange(mask_words(n), device=device)[None, :] >= rows


def greedy_sweep_reference(boxes: torch.Tensor, eligible: torch.Tensor,
                           classes: Optional[torch.Tensor], iou_threshold: float,
                           iou_type: str = "iou", coord: str = "xyxy") -> torch.Tensor:
    """Plain PyTorch sweep: ``(B, N, 4)`` sorted boxes → ``(B, N)`` kept mask.

    ``eligible`` is ``(B, N)`` bool, ``classes`` ``(B, N)`` int ids or None
    (class-agnostic). One step per candidate, as ``tmv_tpu/ops/nms.py:104-119``.
    """
    iou = _iou_fn(coord)
    n = boxes.shape[1]
    idxs = torch.arange(n, device=boxes.device)
    suppressed = torch.zeros(eligible.shape, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep_i = ~suppressed[:, i] & eligible[:, i]
        row = iou(boxes[:, i:i + 1, :], boxes, iou_type=iou_type)
        sup = (row >= iou_threshold) & (idxs > i)
        if classes is not None:
            sup = sup & (classes == classes[:, i:i + 1])
        suppressed = suppressed | (sup & keep_i[:, None])
    return ~suppressed & eligible


def suppression_mask_reference(boxes: torch.Tensor, classes: Optional[torch.Tensor],
                               iou_threshold: float, iou_type: str = "iou",
                               coord: str = "xyxy") -> torch.Tensor:
    """Plain stage 1: the packed ``(B, N, ceil(N / 64))`` int64 suppression mask,
    each pair's IoU computed as the sweep computes it (box i as ``b1``); the
    undefined words are 0."""
    iou = _iou_fn(coord)
    b, n = boxes.shape[:2]
    words = mask_words(n)
    pair = iou(boxes[:, :, None, :], boxes[:, None, :, :], iou_type=iou_type) >= iou_threshold
    idxs = torch.arange(n, device=boxes.device)
    pair &= idxs[None, :] > idxs[:, None]
    if classes is not None:
        pair &= classes[:, :, None] == classes[:, None, :]
    pair = torch.nn.functional.pad(pair, (0, words * WORD - n)).view(b, n, words, WORD)
    shifts = torch.arange(WORD, device=boxes.device, dtype=torch.int64)
    # distinct bits: the wrapping int64 sum is their OR
    return (pair.to(torch.int64) << shifts).sum(-1)


def scan_reference(mask: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """Plain stage 2: one step per candidate; a kept row ORs its defined words
    into the removed bits. Returns the ``(B, N)`` kept mask."""
    b, n = eligible.shape
    removed = torch.zeros((b, mask_words(n)), dtype=torch.int64, device=mask.device)
    for i in range(n):
        w = i // WORD
        gone = ((removed[:, w] >> (i % WORD)) & 1).bool()
        keep = eligible[:, i] & ~gone
        removed[:, w:] |= torch.where(keep[:, None], mask[:, i, w:], 0)
    idxs = torch.arange(n, device=removed.device)
    return (((removed[:, idxs // WORD] >> (idxs % WORD)) & 1) == 0) & eligible


def _check(boxes, eligible, classes, b, n):
    """Refuses what the kernels do not take; ``eligible`` may be None (stage 1)."""
    if boxes.shape != (b, n, 4) or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be ({b}, {n}, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    tensors = [boxes]
    if eligible is not None:
        if eligible.dtype != torch.bool:
            raise ValueError(f"eligible must be bool, got {eligible.dtype}")
        tensors.append(eligible)
    if classes is not None:
        if classes.shape != (b, n) or classes.dtype != torch.int32:
            raise ValueError(f"classes must be ({b}, {n}) int32, got "
                             f"{tuple(classes.shape)} {classes.dtype}")
        tensors.append(classes)
    for t in tensors:
        if t.device != boxes.device or not t.is_contiguous():
            raise ValueError("greedy_sweep: inputs must be contiguous and on one device")
    if boxes.data_ptr() % 16:
        raise ValueError("greedy_sweep: boxes must be 16-byte aligned")
    if n > MAX_CANDIDATES:
        raise ValueError(f"greedy_sweep: {n} candidates exceed the kernel's "
                         f"limit of {MAX_CANDIDATES}")


def _mask_buffer(b, n, device):
    return torch.empty((b, n, mask_words(n)), dtype=torch.int64, device=device)


def _sweep_cuda(boxes, eligible, classes, iou_threshold, iou_type, coord):
    """The kernel's launch (``tmv::nms_sweep``'s CUDA implementation)."""
    b, n = eligible.shape
    _check(boxes, eligible, classes, b, n)
    kept = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return kept
    mask = _mask_buffer(b, n, boxes.device)
    lib = LIBRARY.load()
    # the device made current and its current stream taken by C calls, without a
    # torch.cuda.Stream object: this host work is on every b1 forward's path
    index = boxes.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_nms_sweep(
        boxes.data_ptr(), eligible.data_ptr(),
        classes.data_ptr() if classes is not None else None, mask.data_ptr(),
        kept.data_ptr(), b, n, float(iou_threshold), _VARIANTS[(coord, iou_type)],
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_nms_sweep")
    global launches
    with _lock:
        launches += 1
    return kept


@torch.library.custom_op("tmv::nms_sweep", mutates_args=(), device_types="cpu")
def nms_sweep_op(boxes: torch.Tensor, eligible: torch.Tensor, classes: Optional[torch.Tensor],
                 iou_threshold: float, iou_type: str, coord: str) -> torch.Tensor:
    """``greedy_sweep`` as an op; on the CPU the plain version."""
    return greedy_sweep_reference(boxes, eligible, classes, iou_threshold, iou_type, coord)


register_cuda_kernel(nms_sweep_op, _sweep_cuda)


@nms_sweep_op.register_fake
def _sweep_fake(boxes, eligible, classes, iou_threshold, iou_type, coord):
    return torch.empty(eligible.shape, dtype=torch.bool, device=boxes.device)


def greedy_sweep(boxes: torch.Tensor, eligible: torch.Tensor,
                 classes: Optional[torch.Tensor], iou_threshold: float,
                 iou_type: str = "iou", coord: str = "xyxy") -> torch.Tensor:
    """Kept mask over score-sorted candidates; the CUDA kernel for CUDA tensors.

    Args:
        boxes: ``(B, N, 4)`` float32 boxes in ``coord`` order, each image's
            candidates in descending score order.
        eligible: ``(B, N)`` bool (valid and at or above the score threshold).
        classes: ``(B, N)`` int32 ids for class-aware NMS, or None.

    Returns ``(B, N)`` bool. Does not synchronise.
    """
    if (coord, iou_type) not in _VARIANTS:
        raise ValueError(f"unsupported NMS variant {coord}/{iou_type}")
    if torch.compiler.is_exporting():
        return nms_sweep_op(boxes, eligible, classes, float(iou_threshold), iou_type, coord)
    if boxes.device.type == "cpu":
        return greedy_sweep_reference(boxes, eligible, classes, iou_threshold,
                                      iou_type, coord)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_sweep: no kernel for device {boxes.device}")
    return _sweep_cuda(boxes, eligible, classes, iou_threshold, iou_type, coord)


def suppression_mask(boxes: torch.Tensor, classes: Optional[torch.Tensor],
                     iou_threshold: float, iou_type: str = "iou",
                     coord: str = "xyxy") -> torch.Tensor:
    """Stage 1 alone on the card: the ``(B, N, ceil(N / 64))`` int64 mask (words
    outside ``upper_words`` undefined). Not counted in ``launches``."""
    if (coord, iou_type) not in _VARIANTS:
        raise ValueError(f"unsupported NMS variant {coord}/{iou_type}")
    b, n = boxes.shape[:2]
    _check(boxes, None, classes, b, n)
    mask = _mask_buffer(b, n, boxes.device)
    lib = LIBRARY.load()
    index = boxes.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_nms_mask(
        boxes.data_ptr(), classes.data_ptr() if classes is not None else None,
        mask.data_ptr(), b, n, float(iou_threshold), _VARIANTS[(coord, iou_type)],
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_nms_mask")
    return mask


def scan(mask: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """Stage 2 alone on the card: the kept mask from a stage-1 mask. Not
    counted in ``launches``."""
    b, n = eligible.shape
    if (mask.shape != (b, n, mask_words(n)) or mask.dtype != torch.int64
            or not mask.is_contiguous() or not eligible.is_contiguous()
            or eligible.dtype != torch.bool or mask.device != eligible.device):
        raise ValueError("scan: mask must be a contiguous (B, N, ceil(N / 64)) int64 "
                         "tensor beside a contiguous (B, N) bool eligible")
    kept = torch.empty((b, n), dtype=torch.bool, device=mask.device)
    lib = LIBRARY.load()
    index = mask.device.index
    previous = torch._C._cuda_exchangeDevice(index)
    err = lib.tmv_nms_scan(mask.data_ptr(), eligible.data_ptr(), kept.data_ptr(), b, n,
        torch._C._cuda_getCurrentRawStream(index))
    torch._C._cuda_maybeExchangeDevice(previous)
    LIBRARY.check(err, "tmv_nms_scan")
    return kept
