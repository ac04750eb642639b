"""Greedy NMS suppression sweep: the CUDA kernel, its wrapper and its plain version.

Replaces the Pallas TPU kernel ``tmv_tpu/kernels/nms_pallas.py::greedy_sweep_pallas``
(body ``_sweep_kernel``), which ``tmv_tpu/ops/nms.py::_greedy_nms`` calls for the
suppression loop of both detectors' predict paths. The kernel source is
``tmv_tpu_torch/csrc/nms_sweep.cu``; its header says what bounds it on the H100
(latency: one block barrier per kept box) and what the design does about it.

- ``greedy_sweep`` is the wrapper the port calls. A CUDA tensor launches the
  kernel or raises; a CPU tensor runs ``greedy_sweep_reference``. There is no
  other route and no switch.
- ``greedy_sweep_reference`` is the plain PyTorch version: the sequential loop of
  ``tmv_tpu/ops/nms.py:104-119``, vectorised over the leading image axis. The CPU
  tests and the comparison on the card call it by name.
- ``LIBRARY`` builds the source with ``nvcc`` at first use (``kernels/build.py``)
  and loads it through ``ctypes``.
- ``launches`` counts kernel launches, so that a run can show that its main path
  went through the kernel.
"""

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from tmv_tpu_torch.kernels.build import SM90A_FLAGS, KernelLibrary
from tmv_tpu_torch.ops.iou import iou_xyxy, iou_yxyx

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "nms_sweep.cu"
# 16-byte box + 4-byte class + suppressed and eligible flags per candidate, in
# the 227 KB of shared memory one block may use on Hopper.
MAX_CANDIDATES = 232448 // 22

_VARIANTS = {("xyxy", "iou"): 0, ("xyxy", "diou"): 1,
             ("yxyx", "iou"): 2, ("yxyx", "diou"): 3}


def _bind(lib: ctypes.CDLL):
    lib.tmv_nms_sweep.restype = ctypes.c_int
    lib.tmv_nms_sweep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]


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
    key = (coord, iou_type)
    if key not in _VARIANTS:
        raise ValueError(f"unsupported NMS variant {coord}/{iou_type}")
    if boxes.device.type == "cpu":
        return greedy_sweep_reference(boxes, eligible, classes, iou_threshold,
                                      iou_type, coord)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_sweep: no kernel for device {boxes.device}")
    b, n = eligible.shape
    if boxes.shape != (b, n, 4) or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be ({b}, {n}, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if eligible.dtype != torch.bool:
        raise ValueError(f"eligible must be bool, got {eligible.dtype}")
    tensors = [boxes, eligible]
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
                         f"shared-memory capacity of {MAX_CANDIDATES}")
    kept = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return kept
    lib = LIBRARY.load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tmv_nms_sweep(
            boxes.data_ptr(), eligible.data_ptr(),
            classes.data_ptr() if classes is not None else None,
            kept.data_ptr(), b, n, float(iou_threshold), _VARIANTS[key], stream)
    LIBRARY.check(err, "tmv_nms_sweep")
    global launches
    with _lock:
        launches += 1
    return kept
