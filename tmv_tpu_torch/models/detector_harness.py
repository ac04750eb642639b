"""YOLO-family harness: the training loss, the predictors and the mAP step.

Port of ``tmv_tpu/models/detector_harness.py::build_yolo_model``,
``make_yolo_loss_fn``, ``make_yolo_predict``, ``make_yolo_predict_batched``,
``ground_truth_from_targets``, ``eval_map_step``, ``freeze_mask`` and
``masked_optimizer`` (with ``frozen``, which keeps the frozen parameters out of
the backward pass during the warm-up). The predictors keep the
thresholds and the padded ``(boxes, classes_id, scores, valid)`` contract;
results come back as host numpy arrays, as ``serving.app`` reads them. There is
no ``jit``: the predictors run eagerly under ``torch.inference_mode()``. The
batched form replaces ``jax.vmap`` with a batch axis and one NMS launch.

A predictor keeps the JAX package's signature ``predict(variables, images)`` so
that ``DetectionService`` and ``MicroBatcher`` drive it unchanged; the weights
live in the module it was made with, and ``variables`` is not read (pass None).
Behind it is ``YoloPredictCore``, the tensor-in, tensor-out module that
``serving/export.py`` traces (``predict.core``). ``quant`` (``"int8"``, dynamic;
``"int8_static"``, on a model prepared by ``quant.static.prepare_static_int8``) is
fixed in the core, which runs the forward in ``quant.quantized(quant)``.
"""

import contextlib
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from tmv_tpu_torch.ops.map_eval import get_map_one
from tmv_tpu_torch.ops.yolo import nms_boxes_batched, yolo_loss
from tmv_tpu_torch.quant.dynamic import quantized


def check_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def allocated(model: torch.nn.Module, device, uninitialized: bool) -> torch.nn.Module:
    """``model`` as built; built on the meta device (``uninitialized``), its weights
    allocated on ``device`` without values."""
    return model.to_empty(device=device) if uninitialized else model


def build_yolo_model(version: str, classes_num: int, anchors_per_scale: int = 3,
                     dtype: torch.dtype = torch.float32, device="cuda", param_dtype=None,
                     remat: bool = False, uninitialized: bool = False):
    """Detector factory → ``(model, iou_type)``, on the card unless ``device``
    says otherwise. ``param_dtype`` holds the weights in another type than the
    compute ``dtype`` (training: float32 weights, bf16 activations); ``remat``
    recomputes the stages in the backward (``layers.common.remat_call``).
    ``uninitialized`` leaves the weights without values (built on the meta device,
    then allocated): for a caller that loads or seeds every weight next, it skips
    torch's default init.

    ``version``: 'v4' (CSPDarknet-53, DIoU NMS), 'v3' (Darknet-53, IoU NMS) or
    'resnet', the MoCo/distillation detector (ResNet50V2 + YOLOv3 heads, IoU
    NMS). As in the JAX package, 'v3' has 3 anchors per scale whatever
    ``anchors_per_scale`` says."""
    device = check_device(device)
    kw = dict(dtype=dtype, device="meta" if uninitialized else device, param_dtype=param_dtype,
              remat=remat)
    if version == "v4":
        from tmv_tpu_torch.models.yolo_v4 import YoloV4

        model, iou_type = YoloV4(classes_num, anchors_per_scale, **kw), "diou"
    elif version == "v3":
        from tmv_tpu_torch.models.yolo_v3 import YoloV3

        model, iou_type = YoloV3(classes_num, **kw), "iou"
    elif version == "resnet":
        from tmv_tpu_torch.models.moco import ResNetYoloV3

        model, iou_type = ResNetYoloV3(anchors_per_scale * (5 + classes_num), **kw), "iou"
    else:
        raise ValueError(f"unknown yolo-family version {version!r}")
    return allocated(model, device, uninitialized), iou_type


def make_yolo_loss_fn(image_wh: Tuple[int, int], anchors_wh, iou_thresh: float = 0.5,
                      iou_type: str = "iou"):
    """Loss for ``core.train_state.make_train_step``: ``(model, batch) -> (loss,
    {})``, the model run on ``batch["image"]`` (in train mode, as the step sets
    it) and ``yolo_loss`` against ``batch["targets"]``; v4 trains with
    ``iou_type='ciou'``."""
    anchors = np.asarray(anchors_wh, np.float32)

    def loss_fn(model, batch):
        y_pred = model(batch["image"])
        return yolo_loss(batch["targets"], y_pred, image_wh, anchors, iou_thresh=iou_thresh,
                         iou_type=iou_type), {}

    return loss_fn


def images_to_device(images, model: torch.nn.Module) -> torch.Tensor:
    device = next(model.parameters()).device
    return torch.as_tensor(images).to(device=device, dtype=torch.float32, non_blocking=True)


class YoloPredictCore(torch.nn.Module):
    """The YOLO predict path as a module, tensor in and tensors out: ``(B, H, W, 3)``
    float32 images on the model's device → ``(boxes, classes_id, scores, valid)``,
    padded to ``max_output_size`` with a leading batch axis (boxes normalized xyxy).
    The forward, decode and class-aware NMS run in one ``forward``, and ``quant`` is
    fixed here: the forward runs in ``quantized(quant)``, so a program traced from the
    core (``serving/export.py``) holds the quantized path and reads no thread-local
    when it runs. ``model`` is a submodule: its ``state_dict`` keys gain ``model.``."""

    def __init__(self, model, image_wh: Tuple[int, int], anchors_wh, classes_num: int,
                 confidence_thresh: float = 0.5, scores_thresh: float = 0.3,
                 iou_thresh: float = 0.5, iou_type: str = "iou", max_output_size: int = 500,
                 quant: str = "off"):
        super().__init__()
        self.model = model
        self.anchors = np.asarray(anchors_wh, np.float32)
        self.image_wh = tuple(image_wh)
        self.classes_num = classes_num
        self.nms_kw = dict(confidence_thresh=confidence_thresh, scores_thresh=scores_thresh,
                           iou_thresh=iou_thresh, iou_type=iou_type,
                           max_output_size=max_output_size)
        self.quant = quant

    def forward(self, images: torch.Tensor):
        with quantized(self.quant):
            heads = self.model(images)
        boxes, ids, scores, _classes, _conf, valid = nms_boxes_batched(
            heads, self.anchors, self.image_wh, self.classes_num, **self.nms_kw)
        return boxes, ids, scores, valid


def numpy_predictor(core: torch.nn.Module, model: torch.nn.Module):
    """``predict(variables, (B, H, W, 3) float images)`` → ``core``'s outputs as host
    numpy arrays, under ``torch.inference_mode()``; the images go to ``model``'s
    device. ``predict.core`` is the module (``cli/export_model.py`` exports it)."""

    def predict(_variables, images):
        with torch.inference_mode():
            return tuple(t.cpu().numpy() for t in core(images_to_device(images, model)))

    predict.core = core
    return predict


def make_yolo_predict_batched(model, image_wh: Tuple[int, int], anchors_wh, classes_num: int,
                              confidence_thresh: float = 0.5, scores_thresh: float = 0.3,
                              iou_thresh: float = 0.5, iou_type: str = "iou",
                              max_output_size: int = 500, quant: str = "off"):
    """Batched predictor: ``(variables, (B, H, W, 3) float images)`` → per-image
    padded (boxes, classes_id, scores, valid) numpy arrays with a leading batch
    axis. Boxes are normalized xyxy. ``YoloPredictCore`` behind ``numpy_predictor``."""
    core = YoloPredictCore(model, image_wh, anchors_wh, classes_num, confidence_thresh,
                           scores_thresh, iou_thresh, iou_type, max_output_size, quant)
    return numpy_predictor(core, model)


def make_yolo_predict(model, image_wh: Tuple[int, int], anchors_wh, classes_num: int,
                      **kwargs):
    """Single-image predictor: ``(variables, (1, H, W, 3) float image)`` → padded
    (boxes, classes_id, scores, valid) numpy arrays; keyword arguments are those
    of ``make_yolo_predict_batched``."""
    batched = make_yolo_predict_batched(model, image_wh, anchors_wh, classes_num, **kwargs)

    def predict(variables, image):
        return tuple(o[0] for o in batched(variables, image))

    predict.core = batched.core
    return predict


def ground_truth_from_targets(y_true, classes_num: int) -> np.ndarray:
    """``[x1, y1, x2, y2, class_id]`` rows of one image's per-scale
    ``(h, w, A, 5+C)`` grid targets (``GetGroudTruth``, `yolo_v3/model.py:260-279`)."""
    rows = []
    for t in y_true:
        t = t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
        obj = t[..., 4] > 0
        if not obj.any():
            continue
        sel = t[obj]
        xy, wh = sel[:, 0:2], sel[:, 2:4]
        cid = sel[:, 5:5 + classes_num].argmax(-1)
        rows.append(np.concatenate([xy - wh / 2, xy + wh / 2, cid[:, None]], axis=-1))
    if not rows:
        return np.zeros((0, 5))
    return np.concatenate(rows, axis=0)


def eval_map_step(predict_fn, variables, batch, classes_num: int, thresh: float = 0.5) -> float:
    """Per-batch mAP as the reference ``test_step`` (`yolo_v3/model.py:229-258`):
    predict the batch's one image, compare with its ground truth through the
    quirky evaluator."""
    boxes, ids, scores, valid = predict_fn(variables, batch["image"])
    v = np.asarray(valid)
    pred = np.concatenate([np.asarray(boxes)[v], np.asarray(ids)[v][:, None].astype(np.float64),
                           np.asarray(scores)[v][:, None]], axis=-1)
    gt = ground_truth_from_targets([t[0] for t in batch["targets"]], classes_num)
    return get_map_one(gt.tolist(), pred.tolist(), classes_num, thresh)


def freeze_mask(model: torch.nn.Module, trainable_prefixes: Sequence[str]) -> Dict[str, bool]:
    """``{parameter name: trainable}``: ``FreeLayer`` parity
    (`yolo_v3/model.py:280-291`), as the JAX package's mask over param paths —
    a parameter trains where its flax path (the name with ``/`` for ``.``)
    starts with one of ``trainable_prefixes``. BatchNorm statistics are buffers,
    not parameters, and are not masked."""
    return {name: any(name.replace(".", "/").startswith(p) for p in trainable_prefixes)
            for name, _ in model.named_parameters()}


def masked_optimizer(make_optimizer: Callable, model: torch.nn.Module,
                     mask: Dict[str, bool]) -> torch.optim.Optimizer:
    """The warm-start optimizer (`yolo_v3/train.py:79-87`):
    ``make_optimizer(params)`` over the trainable parameters only, so that a
    frozen parameter gets no update and no optimizer state, as under
    ``optax.masked``. The model is left as it is; ``frozen`` spares the
    backward pass the frozen parameters' gradients."""
    if set(mask) != {name for name, _ in model.named_parameters()}:
        raise KeyError("the mask and the model's parameters differ")
    return make_optimizer([p for name, p in model.named_parameters() if mask[name]])


@contextlib.contextmanager
def frozen(model: torch.nn.Module, mask: Dict[str, bool]):
    """Within the block, the parameters that ``mask`` freezes take no gradient
    (JAX's step computes one and ``optax.masked`` zeroes its update); each
    parameter's ``requires_grad`` is restored on the way out. BatchNorm
    statistics still update in train mode."""
    before = {name: p.requires_grad for name, p in model.named_parameters()}
    try:
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
        yield model
    finally:
        for name, p in model.named_parameters():
            p.requires_grad_(before[name])
