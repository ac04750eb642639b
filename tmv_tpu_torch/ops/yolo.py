"""YOLO head math for prediction: grid decode and the predict/NMS orchestration.

Port of ``tmv_tpu/ops/yolo.py::decode_boxes`` and ``nms_boxes`` (``GetBoxes`` and
``GetNMSBoxes`` of the reference). Shapes stay static: candidates failing the
thresholds are masked, the top ``pre_nms_size`` by class score enter class-aware
NMS. ``nms_boxes_batched`` takes a leading image axis and sends the B images'
candidates to one NMS kernel launch. ``yolo_loss`` waits for the training slice.

Heads are decoded in float32 whatever the forward's dtype. This departs from the
JAX package on purpose: it decodes bf16 heads in bf16, where XLA rounds each of
``exp``, ``1 +`` and ``1 /`` of the sigmoid to bf16 (about a quarter of scores
end one bf16 step off the rounded true value) and bf16 scores tie more often.
The port's decode of bf16 heads equals the JAX decode of the same heads widened
to float32.
"""

from typing import Optional, Sequence, Tuple

import torch

from tmv_tpu_torch.ops.nms import nms_by_classes


def _grid_xy(grid_h: int, grid_w: int, device=None) -> torch.Tensor:
    """(grid_h, grid_w, 1, 2) grid of (x, y) cell indices."""
    gy, gx = torch.meshgrid(torch.arange(grid_h, dtype=torch.float32, device=device),
                            torch.arange(grid_w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)[:, :, None, :]


def decode_boxes(y: torch.Tensor, anchors_wh: torch.Tensor, classes_num: int):
    """Raw head output → normalized corner boxes + sigmoided conf/classes.

    Args:
        y: ``(..., h, w, A, 5+C)`` head output (leading axes optional).
        anchors_wh: ``(A, 2)`` anchors normalized by image size.

    Returns (boxes ``(..., h*w*A, 4)`` xyxy, confidence ``(..., h*w*A)``,
    classes ``(..., h*w*A, C)``, valid ``(..., h*w*A)``).
    """
    lead = y.shape[:-4]
    grid_h, grid_w = y.shape[-4], y.shape[-3]
    confidence = torch.sigmoid(y[..., 4])
    classes = torch.sigmoid(y[..., 5:5 + classes_num])
    grid_wh = torch.tensor([grid_w, grid_h], dtype=torch.float32, device=y.device)
    read_xy = (torch.sigmoid(y[..., 0:2]) + _grid_xy(grid_h, grid_w, y.device)) / grid_wh
    read_wh = torch.exp(y[..., 2:4]) * anchors_wh
    read_wh = torch.where(torch.isinf(read_wh), torch.zeros_like(read_wh), read_wh)
    half = read_wh / 2
    boxes = torch.cat([read_xy - half, read_xy + half], dim=-1)
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    n = grid_h * grid_w * y.shape[-2]
    return (boxes.reshape(*lead, n, 4), confidence.reshape(*lead, n),
            classes.reshape(*lead, n, classes_num), valid.reshape(*lead, n))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows ``idx (B, K)`` of ``x (B, N, ...)``."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def nms_boxes_batched(
    heads: Sequence[torch.Tensor],
    anchors_wh,
    image_wh: Tuple[int, int],
    classes_num: int,
    confidence_thresh: float = 0.5,
    scores_thresh: float = 0.3,
    iou_thresh: float = 0.5,
    iou_type: str = "iou",
    max_output_size: int = 500,
    pre_nms_size: Optional[int] = 1024,
):
    """``nms_boxes`` over a leading image axis: heads ``(B, h, w, A*(5+C))``.

    Returns (boxes, classes_id, scores, classes, confidence, valid), each with a
    leading batch axis and padded to ``max_output_size``.
    """
    device = heads[0].device
    image_wh_f = torch.tensor(image_wh, dtype=torch.float32, device=device)
    anchors_wh_f = torch.as_tensor(anchors_wh, dtype=torch.float32, device=device)
    a_num = anchors_wh_f.shape[1]

    all_boxes, all_conf, all_classes, all_valid = [], [], [], []
    for i, head in enumerate(heads):
        b, h, w = head.shape[0], head.shape[1], head.shape[2]
        head = head.float().reshape(b, h, w, a_num, -1)
        boxes, conf, classes, valid = decode_boxes(head, anchors_wh_f[i] / image_wh_f, classes_num)
        max_cls = torch.amax(classes, dim=-1)
        valid = valid & (conf > confidence_thresh) & (max_cls > scores_thresh)
        all_boxes.append(boxes)
        all_conf.append(conf)
        all_classes.append(classes)
        all_valid.append(valid)

    boxes = torch.cat(all_boxes, dim=1)
    conf = torch.cat(all_conf, dim=1)
    classes = torch.cat(all_classes, dim=1)
    valid = torch.cat(all_valid, dim=1)
    scores = torch.amax(classes, dim=-1)
    # argmax returns the first maximum, as jnp.argmax does
    classes_id = torch.argmax(classes, dim=-1).to(torch.int32)

    # static pre-NMS candidate selection (None = uncapped, exact); a stable
    # descending sort keeps jax.lax.top_k's lower-index-first order on ties
    k = scores.shape[1] if pre_nms_size is None else min(pre_nms_size, scores.shape[1])
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    cand = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :k]

    idx, out_valid = nms_by_classes(
        gather_rows(boxes, cand), gather_rows(scores, cand), gather_rows(classes_id, cand),
        gather_rows(valid, cand), max_output_size=max_output_size,
        iou_threshold=iou_thresh, iou_type=iou_type, coord="xyxy")
    sel = torch.gather(cand, 1, idx.long())
    return (gather_rows(boxes, sel), gather_rows(classes_id, sel), gather_rows(scores, sel),
            gather_rows(classes, sel), gather_rows(conf, sel), out_valid)


def nms_boxes(heads: Sequence[torch.Tensor], anchors_wh, image_wh: Tuple[int, int],
              classes_num: int, **kwargs):
    """Full predict post-process of one image (``GetNMSBoxes``).

    ``heads`` are per-scale ``(h, w, A*(5+C))`` outputs; keyword arguments are
    those of ``nms_boxes_batched``. Returns (boxes, classes_id, scores, classes,
    confidence, valid), all padded to ``max_output_size``.
    """
    out = nms_boxes_batched([h[None] for h in heads], anchors_wh, image_wh,
                            classes_num, **kwargs)
    return tuple(o[0] for o in out)
