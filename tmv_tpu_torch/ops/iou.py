"""IoU families in both of the reference's coordinate conventions.

Port of ``tmv_tpu/ops/iou.py``, quirks included, in the same operation order so
that the NMS kernel (``csrc/nms_sweep.cu``) and this plain version round alike:

- ``iou_xyxy``: corner boxes ``(x1, y1, x2, y2)``; no zero guard on the IoU
  division; DIoU is ``iou - (u/c)**0.6`` with the IoU kept where ``c == 0``;
  CIoU is ``iou - (u/c + alpha·v)`` (plain ``u/c`` there) with the unguarded
  ``atan(w/h)``, differentiated by plain autograd (the YOLO loss's ignore mask).
- ``iou_yxyx``: corner boxes ``(y1, x1, y2, x2)``; clamped widths and heights,
  ``divide_no_nan``; GIoU; standard DIoU ``iou - u/c``; CIoU whose aspect term
  ``v`` has the reference's custom gradient (``CiouV``, a
  ``torch.autograd.Function``).

The max/min use ``torch.maximum``/``torch.minimum``, which split the gradient at
ties as ``jnp.maximum`` does. No caller of the JAX package reaches the yxyx
GIoU/CIoU (EfficientDet's loss is Huber + focal); they are ported for parity.
"""

import math

import torch


def _div_no_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TF ``divide_no_nan``: 0 where the denominator is 0."""
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), a / torch.where(zero, torch.ones_like(b), b))


def _max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(0, x)``: its gradient at 0 is split in halves, as JAX's is."""
    return torch.maximum(x, torch.zeros_like(x))


def iou_xyxy(b1: torch.Tensor, b2: torch.Tensor, iou_type: str = "iou") -> torch.Tensor:
    """Broadcasted IoU/DIoU/CIoU over corner boxes ``(..., 4)`` in xyxy order."""
    if iou_type not in ("iou", "diou", "ciou"):
        raise ValueError(f"iou_xyxy: unsupported iou_type {iou_type!r}")
    inter_mins = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    inter_maxes = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    inter_wh = inter_maxes - inter_mins
    inter_wh = torch.maximum(inter_wh, torch.zeros_like(inter_wh))
    inter_area = inter_wh[..., 0] * inter_wh[..., 1]
    b1_wh = b1[..., 2:4] - b1[..., 0:2]
    b2_wh = b2[..., 2:4] - b2[..., 0:2]
    b1_area = b1_wh[..., 0] * b1_wh[..., 1]
    b2_area = b2_wh[..., 0] * b2_wh[..., 1]
    iou = inter_area / (b1_area + b2_area - inter_area)
    if iou_type == "iou":
        return iou

    ub_wh = torch.maximum(b1[..., 2:4], b2[..., 2:4]) - torch.minimum(b1[..., 0:2], b2[..., 0:2])
    c = ub_wh[..., 0] * ub_wh[..., 0] + ub_wh[..., 1] * ub_wh[..., 1]
    delta = (b1[..., 2:4] + b1[..., 0:2]) / 2 - (b2[..., 2:4] + b2[..., 0:2]) / 2
    u = delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1]
    d = u / c
    if iou_type == "diou":
        # Reference quirk: the distance term is d**0.6 (tf_iou_utils.py:50), not d.
        return torch.where(c == 0.0, iou, iou - d**0.6)

    atan = torch.atan(b1_wh[..., 0] / b1_wh[..., 1]) - torch.atan(b2_wh[..., 0] / b2_wh[..., 1])
    v = 4 / math.pi**2 * (atan * atan)
    alpha = v / (1 - iou + v + 1e-8)
    # Reference quirk: CIoU uses plain d (tf_iou_utils.py:60), not d**0.6.
    return torch.where(c == 0.0, iou, iou - (d + alpha * v))


class CiouV(torch.autograd.Function):
    """CIoU aspect-ratio term ``v = 4/π² (atan(w1/h1) − atan(w2/h2))²`` (divide-
    no-nan ratios) with the reference's custom gradient (``tmv_tpu/ops/iou.py::
    _ciou_v``): w.r.t. the *predicted* box's ``(h, w)`` it is ``−8·atan·w/π²``
    and ``8·atan·h/π²`` (the 1/(h² + w²) factor dropped), zero w.r.t. the
    target's."""

    @staticmethod
    def forward(ctx, h1, w1, h2, w2):
        arctan = torch.atan(_div_no_nan(w1, h1)) - torch.atan(_div_no_nan(w2, h2))
        ctx.save_for_backward(arctan, h2, w2)
        return 4.0 * (arctan / math.pi) ** 2

    @staticmethod
    def backward(ctx, dv):
        arctan, h, w = ctx.saved_tensors
        gdw = dv * 8.0 * arctan * h / (math.pi**2)
        gdh = -dv * 8.0 * arctan * w / (math.pi**2)
        return torch.zeros_like(gdh), torch.zeros_like(gdw), gdh, gdw


def iou_yxyx(boxes1: torch.Tensor, boxes2: torch.Tensor, iou_type: str = "iou") -> torch.Tensor:
    """Broadcasted IoU/GIoU/DIoU/CIoU over ``(..., [y1, x1, y2, x2])`` boxes;
    ``boxes1`` is the target, ``boxes2`` the prediction (the CIoU gradient
    flows to it only)."""
    if iou_type not in ("iou", "giou", "diou", "ciou"):
        raise ValueError(f"iou_yxyx: unsupported iou_type {iou_type!r}")
    b1_ymin, b1_xmin, b1_ymax, b1_xmax = boxes1.unbind(-1)
    b2_ymin, b2_xmin, b2_ymax, b2_xmax = boxes2.unbind(-1)

    b1_width = _max0(b1_xmax - b1_xmin)
    b1_height = _max0(b1_ymax - b1_ymin)
    b2_width = _max0(b2_xmax - b2_xmin)
    b2_height = _max0(b2_ymax - b2_ymin)
    b1_area = b1_width * b1_height
    b2_area = b2_width * b2_height
    inter_area = (
        _max0(torch.minimum(b1_xmax, b2_xmax) - torch.maximum(b1_xmin, b2_xmin))
        * _max0(torch.minimum(b1_ymax, b2_ymax) - torch.maximum(b1_ymin, b2_ymin))
    )
    union_area = b1_area + b2_area - inter_area
    iou = _div_no_nan(inter_area, union_area)
    if iou_type == "iou":
        return iou

    enclose_ymin = torch.minimum(b1_ymin, b2_ymin)
    enclose_xmin = torch.minimum(b1_xmin, b2_xmin)
    enclose_ymax = torch.maximum(b1_ymax, b2_ymax)
    enclose_xmax = torch.maximum(b1_xmax, b2_xmax)
    if iou_type == "giou":
        enclose_area = _max0(enclose_xmax - enclose_xmin) * _max0(enclose_ymax - enclose_ymin)
        return iou - _div_no_nan(enclose_area - union_area, enclose_area)

    dy = (b2_ymin + b2_ymax) / 2 - (b1_ymin + b1_ymax) / 2
    dx = (b2_xmin + b2_xmax) / 2 - (b1_xmin + b1_xmax) / 2
    euclidean_sq = dy * dy + dx * dx
    enclose_h = enclose_ymax - enclose_ymin
    enclose_w = enclose_xmax - enclose_xmin
    diag_sq = enclose_h * enclose_h + enclose_w * enclose_w
    diou = iou - _div_no_nan(euclidean_sq, diag_sq)
    if iou_type == "diou":
        return diou
    v = CiouV.apply(b1_height, b1_width, b2_height, b2_width)
    alpha = _div_no_nan(v, (1 - iou) + v)
    return diou - alpha * v
