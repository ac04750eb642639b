"""EfficientDet harness: the predictors and the eval's predictions and ground truth.

Port of ``tmv_tpu/models/efficientdet/harness.py``. ``make_efficientdet_pred_gt``
and ``make_efficientdet_eval`` compare in the JAX eval's space: yxyx letterbox
pixels, the 1-based class ids ``convert_outputs_one`` returns (0 is background)
and ``num_classes`` with the background; one batched forward and one NMS launch
per batch, where the JAX harness runs NMS per image. The predictors
(``make_efficientdet_predict(_batched)``) keep the contract of the YOLO predictors
(``models/detector_harness.py``): ``(variables, (B, H, W, 3) float [0, 1]
images)`` → padded ``(boxes, classes_id, scores, valid)`` host numpy arrays,
boxes as **normalized xyxy** (the yxyx letterbox pixels divided by
``image_size``), class ids 0-based against the classes file (the internal
background id 0 removed by the shift of −1), padded to 200. The heads are
decoded in float32. The batched form replaces ``jax.vmap`` with one NMS launch
per batch. ``variables`` is not read (pass None): the weights live in the module.
``quant="int8_static"`` runs the forward in ``quant.quantized("int8_static")`` on a
model prepared by ``quant.static.prepare_static_int8``.
"""

import numpy as np
import torch

from tmv_tpu_torch.models.detector_harness import (
    allocated, check_device, images_to_device, numpy_predictor,
)
from tmv_tpu_torch.models.efficientdet.config import get_efficientdet_config
from tmv_tpu_torch.models.efficientdet.net import EfficientDetNet
from tmv_tpu_torch.ops.anchors import Anchors
from tmv_tpu_torch.ops.map_eval import get_map_one
from tmv_tpu_torch.quant.dynamic import quantized


def efficientdet_config(model_name: str, num_classes: int, image_size: int):
    """The D-config for ``model_name`` at ``image_size`` with ``num_classes``
    (background included), its ``levels_size`` recomputed for the size."""
    cfg = get_efficientdet_config(model_name)
    cfg.num_classes = num_classes
    cfg.image_size = image_size
    cfg.levels_size = [image_size]
    for _ in range(cfg.max_level):
        cfg.levels_size.append((cfg.levels_size[-1] + 1) // 2)
    return cfg


def build_efficientdet(model_name: str, num_classes: int, image_size: int,
                       dtype: torch.dtype = torch.float32, device="cuda", param_dtype=None,
                       remat: bool = False, uninitialized: bool = False):
    """``(model, anchors)`` for a D-config at ``image_size``, on the card unless
    ``device`` says otherwise; ``param_dtype`` holds the weights in another type
    than the activations' ``dtype`` (training: float32 weights, bf16 activations);
    ``remat`` sets the config's ``remat`` (the JAX CLI's ``cfg.remat = True``);
    ``uninitialized`` as ``detector_harness.build_yolo_model``'s."""
    device = check_device(device)
    cfg = efficientdet_config(model_name, num_classes, image_size)
    if remat:
        cfg.remat = True
    anchors = Anchors(cfg.min_level, cfg.max_level, (image_size, image_size), cfg.num_scales,
                      cfg.aspect_ratios, cfg.anchor_scale)
    model = EfficientDetNet(cfg, dtype=dtype, device="meta" if uninitialized else device,
                            param_dtype=param_dtype)
    return allocated(model, device, uninitialized), anchors


class EfficientDetPredictCore(torch.nn.Module):
    """The EfficientDet predict path as a module, tensor in and tensors out: ``(B, H,
    W, 3)`` float32 images on the model's device → ``(boxes, classes_id, scores,
    valid)`` in the YOLO predictors' contract (normalized xyxy, 0-based ids, padded
    to ``max_output_size``). ``quant`` is fixed here, as in
    ``detector_harness.YoloPredictCore``."""

    def __init__(self, model, anchors: Anchors, image_size: int, max_output_size: int = 200,
                 iou_threshold: float = 0.5, score_threshold: float = 0.0001,
                 iou_type: str = "diou", quant: str = "off"):
        super().__init__()
        self.model = model
        self.anchors = anchors
        self.image_size = image_size
        self.nms_kw = dict(max_output_size=max_output_size, iou_threshold=iou_threshold,
                           score_threshold=score_threshold, iou_type=iou_type)
        self.quant = quant

    def forward(self, images: torch.Tensor):
        with quantized(self.quant):
            boxes_out, classes_out = self.model(images)
        decoded = self.anchors.convert_outputs_boxes([b.float() for b in boxes_out])
        boxes, ids, scores, valid = self.anchors.convert_outputs_one(
            decoded, [c.float() for c in classes_out], **self.nms_kw)
        # yxyx letterbox pixels → normalized xyxy; background id 0 removed
        boxes = boxes[..., [1, 0, 3, 2]] / float(self.image_size)
        return boxes, ids - 1, scores, valid


def make_efficientdet_predict_batched(model, anchors: Anchors, image_size: int,
                                      max_output_size: int = 200,
                                      iou_threshold: float = 0.5,
                                      score_threshold: float = 0.0001,
                                      iou_type: str = "diou", quant: str = "off"):
    """Batched predictor: ``(variables, (B, H, W, 3) float images)`` → per-image
    padded (boxes, classes_id, scores, valid) numpy arrays with a leading batch
    axis; ``EfficientDetPredictCore`` behind ``numpy_predictor``."""
    core = EfficientDetPredictCore(model, anchors, image_size, max_output_size, iou_threshold,
                                   score_threshold, iou_type, quant)
    return numpy_predictor(core, model)


def make_efficientdet_predict(model, anchors: Anchors, image_size: int, **kwargs):
    """Single-image predictor: ``(variables, (1, H, W, 3) float image)`` → padded
    (boxes, classes_id, scores, valid) numpy arrays; keyword arguments are those
    of ``make_efficientdet_predict_batched``."""
    batched = make_efficientdet_predict_batched(model, anchors, image_size, **kwargs)

    def predict(variables, image):
        return tuple(o[0] for o in batched(variables, image))

    predict.core = batched.core
    return predict


def make_efficientdet_pred_gt(model, anchors: Anchors, quant: str = "off"):
    """``collect(batch) -> [(pred, gt), ...]`` per image of ``batch``, the model
    in eval mode: ``pred`` rows ``[y1, x1, y2, x2, class_id, score]`` after decode,
    background filter and DIoU-NMS; ``gt`` rows ``[y1, x1, y2, x2, class_id]``
    from ``batch["raw"]`` (``EfficientDetPipeline(with_raw_boxes=True)``)."""

    def collect(batch):
        with torch.inference_mode():
            with quantized(quant):
                boxes_out, classes_out = model(images_to_device(batch["image"], model))
            decoded = anchors.convert_outputs_boxes([b.float() for b in boxes_out])
            outs = anchors.convert_outputs_one(decoded, [c.float() for c in classes_out])
            boxes, ids, scores, valid = (t.cpu().numpy() for t in outs)
        result = []
        for b, (raw_boxes, raw_classes) in enumerate(batch["raw"]):
            v = valid[b]
            pred = np.concatenate([boxes[b][v], ids[b][v][:, None].astype(np.float64),
                                   scores[b][v][:, None]], axis=-1)
            gt = np.concatenate([np.asarray(raw_boxes, np.float64).reshape(-1, 4),
                                 np.asarray(raw_classes, np.float64).reshape(-1, 1)], axis=-1)
            result.append((pred, gt))
        return result

    return collect


def make_efficientdet_eval(model, anchors: Anchors, quant: str = "off"):
    """``eval_step(batch) -> {"mAP"}``: the per-image mAP at IoU 0.5 over
    ``model.config.num_classes`` (background included), averaged over the batch."""
    collect = make_efficientdet_pred_gt(model, anchors, quant=quant)

    def eval_step(batch):
        maps = [get_map_one(gt.tolist(), pred.tolist(), model.config.num_classes, 0.5)
                for pred, gt in collect(batch)]
        return {"mAP": float(np.mean(maps))}

    return eval_step
