"""YOLO grid-target assignment, static-shape, batched.

Port of ``tmv_tpu/data/yolo_targets.py`` (the reference's ``GetTargets``,
`datasets/coco_dataset.py:185-285`), over a leading image axis: per GT box, the
best of all 9 anchors by the IoU of the centred wh rectangles gives (layer,
cell_y, cell_x, anchor), and ``[cx, cy, w, h, 1, one_hot]`` is scatter-added
into the per-scale grids; cells where two boxes collide (objectness summed > 1)
are zeroed. The reference's quirks stay: the box centre is a *floor division*
``(x1 + x2) // 2``, and the best-anchor flat index is split by the anchors per
scale. The scatter is one ``index_put_(accumulate=True)`` per scale into a
``(B, gh+1, gw+1, A, 5+C)`` grid whose last row and column take what the JAX
package drops (invalid rows, and indices out of range after negative ones wrap
once, as ``.at[...].add(mode="drop")`` does), sliced off afterwards.
"""

from typing import Sequence, Tuple

import numpy as np
import torch

STRIDES = (32, 16, 8)


def make_yolo_targets(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
                      anchors_wh, image_wh: Tuple[int, int], classes_num: int):
    """Padded GT boxes → per-scale grid targets.

    Args:
        boxes: ``(B, max_boxes, 4)`` xyxy pixel boxes (or ``(max_boxes, 4)`` for
            one image, without the batch axis in the result).
        classes: ``(B, max_boxes)`` int ids.
        valid: ``(B, max_boxes)`` bool.
        anchors_wh: ``(scales, A, 2)`` pixel anchors (scale 0 = coarsest).
        image_wh: (W, H).

    Returns a tuple over scales of ``(B, h, w, A, 5+classes_num)`` float32 targets.
    """
    single = boxes.dim() == 2
    if single:
        boxes, classes, valid = boxes[None], classes[None], valid[None]
    device = boxes.device
    anchors_wh = np.asarray(anchors_wh, np.float32)
    scales, a_num = anchors_wh.shape[0], anchors_wh.shape[1]
    image_wh_f = torch.tensor(image_wh, dtype=torch.float32, device=device)
    boxes = boxes.float()
    valid = valid.bool()

    # centres with the reference's floor-division quirk
    boxes_xy = torch.div(boxes[..., 2:4] + boxes[..., 0:2], 2.0, rounding_mode="floor")
    boxes_wh = boxes[..., 2:4] - boxes[..., 0:2]
    boxes_xy = boxes_xy / image_wh_f
    boxes_wh = boxes_wh / image_wh_f

    # best anchor by centred IoU (intersection of wh rectangles)
    flat = torch.from_numpy(anchors_wh.reshape(-1, 2)).to(device)               # (9, 2) pixels
    inter = torch.minimum(boxes_wh[..., None, :] * image_wh_f, flat)
    inter_area = inter[..., 0] * inter[..., 1]
    box_area = (boxes_wh[..., 0] * image_wh_f[0]) * (boxes_wh[..., 1] * image_wh_f[1])
    anchor_area = flat[:, 0] * flat[:, 1]
    iou = inter_area / (box_area[..., None] + anchor_area - inter_area)
    anchors_idx = torch.argmax(iou, dim=-1)
    layer_index = anchors_idx // a_num
    anchor_index = anchors_idx % a_num

    one_hot = (classes[..., None].long()
               == torch.arange(classes_num, device=device)).float()
    updates = torch.cat([boxes_xy, boxes_wh, torch.ones_like(boxes_xy[..., :1]), one_hot], -1)
    updates = updates * valid[..., None].float()
    image_index = torch.arange(boxes.shape[0], device=device)[:, None].expand_as(valid)

    targets = []
    for li, stride in enumerate(STRIDES[:scales]):
        gh, gw = image_wh[1] // stride, image_wh[0] // stride
        grid_hw = torch.tensor([gh, gw], dtype=torch.float32, device=device)
        cell = torch.floor(boxes_xy.flip(-1) * grid_hw).long()
        in_layer = valid & (layer_index == li)
        y_idx = torch.where(in_layer, cell[..., 0], gh)
        x_idx = torch.where(in_layer, cell[..., 1], gw)
        y_idx = torch.where(y_idx < 0, y_idx + gh + 1, y_idx)
        x_idx = torch.where(x_idx < 0, x_idx + gw + 1, x_idx)
        inside = (y_idx >= 0) & (y_idx <= gh) & (x_idx >= 0) & (x_idx <= gw)
        y_idx = torch.where(inside, y_idx, gh)
        x_idx = torch.where(inside, x_idx, gw)
        t = torch.zeros((boxes.shape[0], gh + 1, gw + 1, a_num, 5 + classes_num),
                        dtype=torch.float32, device=device)
        t.index_put_((image_index, y_idx, x_idx, anchor_index),
                     updates * in_layer[..., None].float(), accumulate=True)
        t = t[:, :gh, :gw]
        # de-dup: collided cells (obj summed > 1) are zeroed
        t = t * (t[..., 4:5] <= 1.0).float()
        targets.append(t[0] if single else t)
    return tuple(targets)


def pad_labels(boxes: np.ndarray, classes: Sequence[int], max_boxes: int):
    """Host-side: pad variable GT lists to (max_boxes, …) + mask."""
    n = min(len(classes), max_boxes)
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_classes = np.zeros((max_boxes,), np.int32)
    out_valid = np.zeros((max_boxes,), bool)
    if n:
        out_boxes[:n] = boxes[:n]
        out_classes[:n] = np.asarray(classes[:n], np.int32)
        out_valid[:n] = True
    return out_boxes, out_classes, out_valid
