"""YOLO-family prediction harness: forward + decode + class-aware NMS.

Port of ``tmv_tpu/models/detector_harness.py::build_yolo_model``,
``make_yolo_predict`` and ``make_yolo_predict_batched`` with the same thresholds
and the same padded ``(boxes, classes_id, scores, valid)`` contract. Results come
back as host numpy arrays, as ``tmv_tpu.serving.app`` reads them. There is no
``jit``: the predictors run eagerly under ``torch.inference_mode()``. The batched
form replaces ``jax.vmap`` with a batch axis and one NMS launch.

A predictor keeps the JAX package's signature ``predict(variables, images)`` so
that ``DetectionService`` and ``MicroBatcher`` drive it unchanged; the weights
live in the module it was made with, and ``variables`` is not read (pass None).
"""

from typing import Tuple

import numpy as np
import torch

from tmv_tpu_torch.ops.yolo import nms_boxes_batched


def build_yolo_model(version: str, classes_num: int, anchors_per_scale: int = 3,
                     dtype: torch.dtype = torch.float32, device=None):
    """Detector factory → ``(model, iou_type)``. Only 'v4' is ported so far."""
    if version == "v4":
        from tmv_tpu_torch.models.yolo_v4 import YoloV4

        return YoloV4(classes_num, anchors_per_scale, dtype=dtype, device=device), "diou"
    raise ValueError(f"yolo-family version {version!r} is not ported to tmv_tpu_torch yet")


def images_to_device(images, model: torch.nn.Module) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.as_tensor(images).to(device=device, dtype=torch.float32, non_blocking=True)


def make_yolo_predict_batched(model, image_wh: Tuple[int, int], anchors_wh, classes_num: int,
                              confidence_thresh: float = 0.5, scores_thresh: float = 0.3,
                              iou_thresh: float = 0.5, iou_type: str = "iou",
                              max_output_size: int = 500):
    """Batched predictor: ``(variables, (B, H, W, 3) float images)`` → per-image
    padded (boxes, classes_id, scores, valid) numpy arrays with a leading batch
    axis. Boxes are normalized xyxy."""
    anchors = np.asarray(anchors_wh, np.float32)

    def predict(_variables, images):
        with torch.inference_mode():
            heads = model(images_to_device(images, model))
            boxes, ids, scores, _classes, _conf, valid = nms_boxes_batched(
                heads, anchors, image_wh, classes_num,
                confidence_thresh=confidence_thresh, scores_thresh=scores_thresh,
                iou_thresh=iou_thresh, iou_type=iou_type,
                max_output_size=max_output_size)
            return tuple(t.cpu().numpy() for t in (boxes, ids, scores, valid))

    return predict


def make_yolo_predict(model, image_wh: Tuple[int, int], anchors_wh, classes_num: int,
                      **kwargs):
    """Single-image predictor: ``(variables, (1, H, W, 3) float image)`` → padded
    (boxes, classes_id, scores, valid) numpy arrays; keyword arguments are those
    of ``make_yolo_predict_batched``."""
    batched = make_yolo_predict_batched(model, image_wh, anchors_wh, classes_num, **kwargs)

    def predict(variables, image):
        return tuple(o[0] for o in batched(variables, image))

    return predict
