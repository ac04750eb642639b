"""Teacher→student self-distillation: the pseudo-labeler and teacher promotion.

Port of ``tmv_tpu/models/distill.py`` (the reference's
`unsupervised_learning/teacher_dataset.py:90-186` and
`create_teacher_weights.py:28-53`). The teacher is a ``ResNetYoloV3``; its
predictions at a confidence threshold drawn per image, uniform in [0.3, 0.5),
become the student's training boxes.

The labeler runs one batched eval forward and one ``nms_boxes_batched`` call per
batch, so one class-aware IoU sweep (the CUDA kernel on the card) labels the
whole batch, where JAX ``vmap``\\ s ``nms_boxes`` over the images. The draws come
from a ``torch.Generator`` (on the images' device) where JAX splits a key per
image; ``label(images, conf=...)`` takes JAX's draws instead.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.ops.yolo import nms_boxes_batched

CONF_RANGE = (0.3, 0.5)


def draw_confidence(batch: int, generator: torch.Generator) -> torch.Tensor:
    """``(batch, 1)`` float32 thresholds, uniform in ``CONF_RANGE``, from
    ``generator`` on its device (`teacher_dataset.py:141`)."""
    lo, hi = CONF_RANGE
    u = torch.rand((batch, 1), generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def make_pseudo_label_fn(model: nn.Module, anchors_wh, image_wh: Tuple[int, int],
                         classes_num: int, max_boxes: int = 100, scores_thresh: float = 0.3,
                         iou_thresh: float = 0.5):
    """The teacher labeler ``label(images, generator=None, conf=None) ->
    (boxes, ids, valid)``: NHWC float images ``(B, H, W, 3)`` on the model's
    device → pixel xyxy boxes of the letterboxed image ``(B, max_boxes, 4)``,
    int32 class ids and the bool valid mask, padded like ``nms_boxes``. The
    per-image confidence thresholds are ``conf`` (``(B,)`` or ``(B, 1)``, e.g.
    JAX's draws) or drawn from ``generator``. IoU NMS, class-aware, on xyxy.
    The model runs in eval mode without a graph."""
    anchors = np.asarray(anchors_wh, np.float32)

    def label(images: torch.Tensor, generator: Optional[torch.Generator] = None,
              conf: Optional[torch.Tensor] = None):
        if conf is None:
            if generator is None:
                raise ValueError("the labeler needs a generator or the thresholds")
            conf = draw_confidence(images.shape[0], generator)
        conf = torch.as_tensor(conf, dtype=torch.float32, device=images.device).reshape(-1, 1)
        model.eval()
        with torch.no_grad():
            heads = model(images)
            boxes, ids, _scores, _classes, _conf, valid = nms_boxes_batched(
                heads, anchors, image_wh, classes_num, confidence_thresh=conf,
                scores_thresh=scores_thresh, iou_thresh=iou_thresh, iou_type="iou",
                max_output_size=max_boxes)
            scale = torch.tensor([image_wh[0], image_wh[1], image_wh[0], image_wh[1]],
                                 dtype=torch.float32, device=boxes.device)
        return boxes * scale, ids, valid

    return label


def promote_teacher(student: nn.Module, teacher: nn.Module) -> nn.Module:
    """Copy the student's parameters and BatchNorm statistics into the teacher
    (`create_teacher_weights.py:28-53`); returns the teacher."""
    with torch.no_grad():
        teacher.load_state_dict({k: v.detach().clone() for k, v in student.state_dict().items()},
                                strict=True)
    return teacher
