"""YOLO head math: loss, grid decode and the predict/NMS orchestration.

Port of ``tmv_tpu/ops/yolo.py::yolo_loss``, ``decode_boxes`` and ``nms_boxes``
(``GetLoss``, ``GetBoxes`` and ``GetNMSBoxes`` of the reference). Shapes stay
static: candidates failing the thresholds are masked, the top ``pre_nms_size`` by
class score enter class-aware NMS. ``nms_boxes_batched`` takes a leading image
axis and sends the B images' candidates to one NMS kernel launch.

Heads are decoded in float32 whatever the forward's dtype. This departs from the
JAX package on purpose: it decodes bf16 heads in bf16, where XLA rounds each of
``exp``, ``1 +`` and ``1 /`` of the sigmoid to bf16 (about a quarter of scores
end one bf16 step off the rounded true value) and bf16 scores tie more often.
The port's decode of bf16 heads equals the JAX decode of the same heads widened
to float32.
"""

from typing import Optional, Sequence, Tuple, Union

import torch

from tmv_tpu_torch.ops.iou import iou_xyxy
from tmv_tpu_torch.ops.losses import sigmoid_cross_entropy
from tmv_tpu_torch.ops.nms import nms_by_classes


def _grid_xy(grid_h: int, grid_w: int, device=None) -> torch.Tensor:
    """(grid_h, grid_w, 1, 2) grid of (x, y) cell indices."""
    gy, gx = torch.meshgrid(torch.arange(grid_h, dtype=torch.float32, device=device),
                            torch.arange(grid_w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)[:, :, None, :]


def _ignore_mask(y_true_object, y_true_boxes, y_pred_boxes, iou_thresh, iou_type, k):
    """1 where a prediction's best IoU against the image's GT boxes is below
    ``iou_thresh`` (-inf, so 1, for an image without GT). The GT boxes are
    compacted by cumsum into ``k`` slots, a scatter into a ``(k+1)``-row buffer
    whose last row takes the boxes past the capacity and is dropped. A
    comparison has no gradient, so this runs without autograd."""
    batch = y_true_object.shape[0]
    with torch.no_grad():
        is_gt = y_true_object[..., 0].reshape(batch, -1) > 0                  # (B, hwA)
        slots = torch.where(is_gt, torch.cumsum(is_gt, 1) - 1, k).clamp_max(k)
        boxes = y_true_boxes.reshape(batch, -1, 4)
        gt_boxes = boxes.new_zeros((batch, k + 1, 4)).scatter_(
            1, slots[..., None].expand(-1, -1, 4), boxes)[:, :k]
        gt_valid = is_gt.new_zeros((batch, k + 1)).scatter_(1, slots, is_gt)[:, :k]
        iou = iou_xyxy(y_pred_boxes.detach().reshape(batch, -1, 1, 4), gt_boxes[:, None],
                       iou_type)                                               # (B, hwA, k)
        iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, float("-inf")))
        best_iou = torch.amax(iou, dim=-1)
        return (best_iou < iou_thresh).to(y_true_object.dtype).reshape(y_true_object.shape)


def yolo_loss(y_true: Sequence[torch.Tensor], y_pred: Sequence[torch.Tensor],
              image_wh: Tuple[int, int], anchors_wh, iou_thresh: float = 0.5,
              iou_type: str = "iou", max_true_boxes: int = 100) -> torch.Tensor:
    """YOLO multi-scale detection loss (``GetLoss`` semantics), in float32 for
    bf16 or float32 heads (float64 heads stay float64).

    Args:
        y_true: per scale ``(B, h, w, A, 5+C)`` targets; xy/wh normalized to [0, 1]
            image coordinates, slot 4 objectness.
        y_pred: per scale raw head outputs, ``(B, h, w, A*(5+C))`` or the same shape.
        image_wh: (W, H) of the input image.
        anchors_wh: ``(scales, A, 2)`` anchor (w, h) in pixels.
        max_true_boxes: capacity of per-image GT boxes of one scale in the
            ignore mask; boxes past it are left out, as in the JAX package.

    Returns the scalar loss: the sum over scales, divided by the batch size.
    """
    device = y_true[0].device
    dtype = torch.promote_types(y_pred[0].dtype, torch.float32)
    image_wh_f = torch.tensor(image_wh, dtype=dtype, device=device)
    anchors_wh_f = torch.as_tensor(anchors_wh, dtype=torch.float32).to(device, dtype)
    batch = y_true[0].shape[0]

    loss = torch.zeros((), dtype=dtype, device=device)
    for layer_index, (y_true_read, y_pred_layer) in enumerate(zip(y_true, y_pred)):
        y_true_read = y_true_read.to(dtype)
        y_pred_raw = y_pred_layer.to(dtype).reshape(y_true_read.shape)
        grid_h, grid_w = y_pred_raw.shape[1], y_pred_raw.shape[2]
        grid_xy = _grid_xy(grid_h, grid_w, device).to(dtype)
        grid_wh_f = torch.tensor([grid_w, grid_h], dtype=dtype, device=device)
        anchors = anchors_wh_f[layer_index]

        y_true_object = y_true_read[..., 4:5]
        y_true_classes = y_true_read[..., 5:]
        y_true_read_xy = y_true_read[..., 0:2]
        y_true_raw_xy = y_true_object * (y_true_read_xy * grid_wh_f - grid_xy)
        y_true_read_wh = y_true_read[..., 2:4]
        y_true_raw_wh = torch.log((y_true_read_wh * image_wh_f + 1e-8) / anchors)
        y_true_raw_wh = torch.where(y_true_object > 0, y_true_raw_wh,
                                    torch.zeros_like(y_true_raw_wh))

        y_pred_object = y_pred_raw[..., 4:5]
        y_pred_classes = y_pred_raw[..., 5:]
        y_pred_raw_xy = y_pred_raw[..., 0:2]
        y_pred_read_xy = (torch.sigmoid(y_pred_raw_xy) + grid_xy) / grid_wh_f
        y_pred_raw_wh = y_pred_raw[..., 2:4]
        y_pred_read_wh = torch.exp(y_pred_raw_wh) * anchors / image_wh_f

        t_half = y_true_read_wh / 2
        y_true_boxes = torch.cat([y_true_read_xy - t_half, y_true_read_xy + t_half], dim=-1)
        p_half = y_pred_read_wh / 2
        y_pred_boxes = torch.cat([y_pred_read_xy - p_half, y_pred_read_xy + p_half], dim=-1)
        k = min(max_true_boxes, grid_h * grid_w * y_true_read.shape[3])
        ignore_mask = _ignore_mask(y_true_object, y_true_boxes, y_pred_boxes, iou_thresh,
                                   iou_type, k)

        boxes_loss_scale = 2 - y_true_read_wh[..., 0:1] * y_true_read_wh[..., 1:2]
        xy_loss = (y_true_object * boxes_loss_scale
                   * sigmoid_cross_entropy(y_true_raw_xy, y_pred_raw_xy))
        wh_diff = y_true_raw_wh - y_pred_raw_wh
        wh_loss = y_true_object * boxes_loss_scale * 0.5 * (wh_diff * wh_diff)
        object_loss_bc = sigmoid_cross_entropy(y_true_object, y_pred_object)
        object_loss = (y_true_object * object_loss_bc
                       + (1 - y_true_object) * object_loss_bc * ignore_mask)
        classes_loss = y_true_object * sigmoid_cross_entropy(y_true_classes, y_pred_classes)
        loss = loss + (xy_loss.sum() + wh_loss.sum() + object_loss.sum()
                       + classes_loss.sum()) / batch
    return loss


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
    confidence_thresh: Union[float, torch.Tensor] = 0.5,
    scores_thresh: float = 0.3,
    iou_thresh: float = 0.5,
    iou_type: str = "iou",
    max_output_size: int = 500,
    pre_nms_size: Optional[int] = 1024,
):
    """``nms_boxes`` over a leading image axis: heads ``(B, h, w, A*(5+C))``.

    ``confidence_thresh`` is one float or a ``(B, 1)`` tensor of per-image
    thresholds (the distillation labeler's draws); it only gates the candidates.

    Returns (boxes, classes_id, scores, classes, confidence, valid), each with a
    leading batch axis and padded to ``max_output_size``.
    """
    device = heads[0].device
    if torch.is_tensor(confidence_thresh):
        confidence_thresh = confidence_thresh.to(device=device, dtype=torch.float32)
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
