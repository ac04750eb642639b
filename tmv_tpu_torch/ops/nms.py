"""Static-shape greedy NMS (plain / class-aware / score-thresholded).

Port of ``tmv_tpu/ops/nms.py`` with the same contract: ``(indices int32
(max_output_size,), valid bool)``, score-descending, padded with 0. Every
function also takes a leading image axis (boxes ``(B, N, 4)``), and then runs the
B images' sweeps in one kernel launch.

The sort, the eligibility mask and the cumsum/scatter compaction are torch ops;
the suppression sweep is ``kernels.nms_sweep.greedy_sweep`` (the CUDA kernel on
a CUDA tensor, the plain loop on a CPU tensor). ``soft_nms`` (Gaussian decay,
dormant in the reference) is plain torch: no TPU kernel stands behind it.
"""

from typing import Optional

import torch

from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep
from tmv_tpu_torch.ops.iou import iou_xyxy, iou_yxyx

_NEG_INF = float("-inf")


def _greedy_nms(boxes, scores, valid, classes, max_output_size, iou_threshold,
                score_threshold, iou_type, coord):
    unbatched = boxes.dim() == 2
    if unbatched:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
        classes = None if classes is None else classes[None]
    b = boxes.shape[0]

    neg = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    # stable, like jnp.argsort(stable=True): ties keep the lower index first
    order = torch.sort(-neg, dim=-1, stable=True).indices
    boxes_s = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4)).contiguous()
    eligible = torch.gather(valid, 1, order) & (torch.gather(scores, 1, order) >= score_threshold)
    classes_s = None
    if classes is not None:
        classes_s = torch.gather(classes, 1, order).to(torch.int32).contiguous()

    kept = greedy_sweep(boxes_s, eligible.contiguous(), classes_s, iou_threshold, iou_type, coord)

    # First `max_output_size` kept boxes, in score order (= reference order).
    rank = torch.cumsum(kept.to(torch.int32), dim=-1) - 1
    kept = kept & (rank < max_output_size)
    slot = torch.where(kept, rank, max_output_size).long()
    out_idx = torch.zeros((b, max_output_size + 1), dtype=torch.int32, device=boxes.device)
    out_idx.scatter_(1, slot, order.to(torch.int32))
    out_valid = torch.zeros((b, max_output_size + 1), dtype=torch.bool, device=boxes.device)
    out_valid.scatter_(1, slot, kept)
    # the spill slot received every dropped candidate; cut it off
    out_idx, out_valid = out_idx[:, :max_output_size], out_valid[:, :max_output_size]
    if unbatched:
        return out_idx[0], out_valid[0]
    return out_idx, out_valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: Optional[torch.Tensor] = None,
        max_output_size: int = 500, iou_threshold: float = 0.5,
        score_threshold: float = _NEG_INF, iou_type: str = "iou", coord: str = "xyxy"):
    """Greedy NMS over padded candidates.

    Args:
        boxes: ``(N, 4)`` or ``(B, N, 4)`` corner boxes in ``coord`` convention.
        scores: ``(N,)`` or ``(B, N)``.
        valid: bool padding mask of the scores' shape (None = all valid).
        score_threshold: candidates below it are dropped.

    Returns ``(indices, valid_out)``: int32 ``(..., max_output_size)`` indices
    into the input (padded with 0) and a bool mask of real entries, ordered by
    descending score.
    """
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return _greedy_nms(boxes, scores, valid, None, max_output_size, iou_threshold,
                       score_threshold, iou_type, coord)


def nms_by_classes(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                   valid: Optional[torch.Tensor] = None, max_output_size: int = 500,
                   iou_threshold: float = 0.5, score_threshold: float = _NEG_INF,
                   iou_type: str = "iou", coord: str = "xyxy"):
    """Class-aware greedy NMS: a box only suppresses boxes of its own class."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return _greedy_nms(boxes, scores, valid, classes, max_output_size, iou_threshold,
                       score_threshold, iou_type, coord)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: Optional[torch.Tensor] = None,
             max_output_size: int = 500, sigma: float = 0.5, score_threshold: float = 0.001,
             coord: str = "yxyx"):
    """Gaussian soft-NMS over ``(N, 4)`` boxes: ``max_output_size`` sequential
    picks of the best live score; each pick whose score reaches
    ``score_threshold`` decays every live score by ``exp(−IoU² / sigma)`` and
    leaves the pool. Returns ``(indices int32, scores, valid)``, each
    ``(max_output_size,)``; a pick below the threshold gives index 0, score 0
    and valid False (`utils/nms_np.py`'s capability)."""
    iou = {"xyxy": iou_xyxy, "yxyx": iou_yxyx}[coord]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    live = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    out_idx, out_score, out_ok = [], [], []
    for _ in range(max_output_size):
        top = torch.argmax(live)           # the first maximum, as jnp.argmax
        top_score = live[top]
        ok = top_score >= score_threshold
        decay = torch.exp(-(iou(boxes[top][None, :], boxes) ** 2) / sigma)
        live = torch.where(ok, live * decay, live)
        live[top] = _NEG_INF
        out_idx.append(torch.where(ok, top, 0).to(torch.int32))
        out_score.append(torch.where(ok, top_score, 0.0))
        out_ok.append(ok)
    return torch.stack(out_idx), torch.stack(out_score), torch.stack(out_ok)
