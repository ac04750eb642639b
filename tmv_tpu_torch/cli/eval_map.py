"""Dataset mAP evaluation CLI for a trained YOLO or EfficientDet of the port.

Port of ``tmv_tpu/cli/eval_map.py`` for ``--family yolo`` (``--version v4``
with DIoU NMS, ``v3`` and ``resnet`` with IoU NMS) and ``--family
efficientdet``:

- ``--mode batch`` (default): per-image mAP averaged over the set, the
  reference's ``test_step`` semantics; ``--mode global`` pools all images into
  one PR curve per class;
- ``--variant reference|voc|coco`` picks the AP integrator
  (``ops/map_eval.py::get_ap{,_voc,_coco}``).

``--modelPath`` is a port checkpoint directory (``cli/train_yolo.py``,
``cli/train_efficientdet.py``, ``cli/convert_darknet.py``; the latest step) or
a ``.pt`` state_dict;
omitted, the model is seeded random weights (a smoke run only). YOLO images go
through the batched predictor; EfficientDet batches through one eval-mode
forward (the depthwise kernel on the card) and one NMS sweep, scored in the JAX
eval's space (yxyx letterbox pixels, 1-based ids, ``num_classes`` = the
dataset's classes + background). ``--cacheDir`` (yolo family only, as in the
JAX CLI) stages the set through the memmap cache of ``data/stage_cache.py``,
so a repeated evaluation of the same set decodes nothing. ``--device cuda``
(the default) raises where there is no GPU.

``--int8Static`` scores the static int8 serving path: activation scales are
calibrated on the first 16 images of the set (``--int8PerChannel``,
``--int8Margin`` as the server's), then every ConvBN (YOLO) or backbone, BiFPN and
head conv site (EfficientDet; the head ``predict`` stays float) runs through the
int8 conv kernels; the result records ``quant`` and, off 1.0, ``int8_margin``.

Usage:
    python -m tmv_tpu_torch.cli.eval_map --family yolo --version v4 \\
        --imagePath imgs/ --labelFile labels.txt --classesFile classes.txt \\
        --anchorsFile anchors.txt --modelPath ./weights --imageSize 416
    python -m tmv_tpu_torch.cli.eval_map --family efficientdet \\
        --modelName efficientdet-d0 --imagePath imgs/ --labelFile labels.txt \\
        --classesFile classes.txt --modelPath ./weights --imageSize 512
"""

import argparse
import json

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", default="yolo", choices=["yolo", "efficientdet"])
    p.add_argument("--version", default="v4", choices=["v3", "v4", "resnet"])
    p.add_argument("--modelName", default="efficientdet-d0")
    p.add_argument("--imagePath", required=True)
    p.add_argument("--labelFile", required=True)
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsFile", default=None, help="required for --family yolo")
    p.add_argument("--modelPath", default=None,
                   help="checkpoint dir or .pt (omit = seeded random weights, smoke only)")
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--maxImages", type=int, default=0,
                   help="cap evaluated images (0 = whole set once)")
    p.add_argument("--batchSize", type=int, default=1,
                   help="images per predictor call (per-image results are identical)")
    p.add_argument("--mode", default="batch", choices=["batch", "global"])
    p.add_argument("--variant", default="reference", choices=["reference", "voc", "coco"])
    p.add_argument("--thresh", type=float, default=0.5,
                   help="IoU match threshold (non-coco variants)")
    p.add_argument("--confidenceThresh", type=float, default=0.5)
    p.add_argument("--scoresThresh", type=float, default=0.2)
    p.add_argument("--iouThresh", type=float, default=0.5)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cacheDir", default=None,
                   help="staging cache directory (yolo family only; data/stage_cache.py)")
    p.add_argument("--int8Static", action="store_true",
                   help="score the static int8 path: calibrate activation scales on the "
                        "first 16 images, then predict through the int8 conv kernels")
    p.add_argument("--int8Margin", type=float, default=1.0,
                   help="multiplier on the calibrated activation absmax (<1 clips outliers)")
    p.add_argument("--int8PerChannel", action="store_true",
                   help="per-input-channel activation scales (folded into the weights)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.family == "yolo" and args.anchorsFile is None:
        p.error("--anchorsFile is required for --family yolo")
    if args.cacheDir and args.family != "yolo":
        p.error("--cacheDir is yolo-family only (the efficientdet eval stages through "
                "the host-aug loader)")
    return args


def score_dataset(data, classes_num: int, mode: str, variant: str, thresh: float) -> float:
    """Score per-image records (``{"image_path", "groud_truth", "prediction"}``,
    the reference evaluator's format) under ``mode`` × ``variant``."""
    from tmv_tpu_torch.ops.map_eval import get_map, get_map_coco

    def one(subset):
        if variant == "coco":
            return get_map_coco(subset, classes_num)
        return get_map(subset, classes_num, thresh, variant=variant)

    if mode == "global":
        return float(one(data))
    per_image = [one([d]) for d in data]
    return float(np.mean(per_image)) if per_image else 0.0


def load_weights(args, model):
    """``--modelPath`` into ``model`` (built without weight values; seeded random
    weights where ``--modelPath`` is omitted) → the model in ``channels_last`` and
    eval mode."""
    import torch

    from tmv_tpu_torch.core import checkpoint

    if args.modelPath is None:
        if args.family == "yolo":
            from tmv_tpu_torch.models.layers.common import init_weights
        else:
            from tmv_tpu_torch.models.efficientdet.net import init_weights
        init_weights(model, 0)
    else:
        step = checkpoint.load_weights(model, args.modelPath)
        if step is not None:
            print(f"checkpoint at step {step}", flush=True)
    return model.to(memory_format=torch.channels_last).eval()


def calibrate(args, model, pipeline) -> str:
    """With ``--int8Static``, calibrate ``model`` on the first 16 images of
    ``pipeline`` and prepare its int8 sites → the predictors' ``quant``."""
    if not args.int8Static:
        return "off"
    from tmv_tpu_torch.quant.static import calibrate_model, prepare_static_int8

    batches = iter(pipeline)
    try:
        calib = [next(batches)["image"]
                 for _ in range(max(1, (16 + args.batchSize - 1) // args.batchSize))]
    finally:
        batches.close()
    print(f"calibrating int8 scales on {sum(len(c) for c in calib)} images...", flush=True)
    prepare_static_int8(model, calibrate_model(model, calib), margin=args.int8Margin,
                        per_channel=args.int8PerChannel)
    return "int8_static"


def load_model(args, classes_num: int, anchors_per_scale: int, device):
    """The YOLO (``--version``) of ``--modelPath`` on ``device`` in eval mode →
    (model, iou_type)."""
    import torch

    from tmv_tpu_torch.models.detector_harness import build_yolo_model

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, iou_type = build_yolo_model(args.version, classes_num, anchors_per_scale,
                                       dtype=dtype, device=device, uninitialized=True)
    return load_weights(args, model), iou_type


def predict_records(args):
    """Predict every image of the set → (per-image records in the reference
    evaluator's format, classes_num)."""
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.models.detector_harness import (
        check_device, ground_truth_from_targets, make_yolo_predict_batched,
    )

    device = check_device(args.device)
    anchors = load_anchors(args.anchorsFile)
    image_wh = (args.imageSize, args.imageSize)
    pipeline = YoloDataPipeline(args.imagePath, args.labelFile, args.classesFile,
                                args.batchSize, anchors, image_wh=image_wh, image_random=False,
                                label_mean=False, cache_dir=args.cacheDir, device=device)
    classes_num = pipeline.classes_num
    model, iou_type = load_model(args, classes_num, anchors.shape[1], device)
    predict_b = make_yolo_predict_batched(
        model, image_wh, anchors, classes_num, confidence_thresh=args.confidenceThresh,
        scores_thresh=args.scoresThresh, iou_thresh=args.iouThresh, iou_type=iou_type,
        quant=calibrate(args, model, pipeline))

    n = args.maxImages or pipeline.labels_num
    data = []
    batches = iter(pipeline)
    try:
        for bi in range((n + args.batchSize - 1) // args.batchSize):
            batch = next(batches)
            boxes_b, ids_b, scores_b, valid_b = predict_b(None, batch["image"])
            for j in range(min(args.batchSize, n - bi * args.batchSize)):
                v = valid_b[j]
                pred = np.concatenate([boxes_b[j][v], ids_b[j][v][:, None].astype(np.float64),
                                       scores_b[j][v][:, None]], axis=-1)
                gt = ground_truth_from_targets([t[j] for t in batch["targets"]], classes_num)
                data.append({"image_path": f"{bi * args.batchSize + j}.jpg",
                             "groud_truth": gt.tolist(), "prediction": pred.tolist()})
    finally:
        batches.close()
    return data, classes_num


def eval_yolo(args):
    data, classes_num = predict_records(args)
    return {"mAP": score_dataset(data, classes_num, args.mode, args.variant, args.thresh),
            "images": len(data)}


def efficientdet_records(args):
    """Predict every image of the set with the EfficientDet of ``--modelPath`` →
    (per-image records in the reference evaluator's format, num_classes with
    the background)."""
    import torch

    from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline
    from tmv_tpu_torch.data.loaders import load_classes
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.models.efficientdet.config import get_efficientdet_config
    from tmv_tpu_torch.models.efficientdet.harness import (
        build_efficientdet, make_efficientdet_pred_gt,
    )

    device = check_device(args.device)
    _, names_num = load_classes(args.classesFile)
    size = args.imageSize or get_efficientdet_config(args.modelName).image_size
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, anchors = build_efficientdet(args.modelName, names_num + 1, size, dtype=dtype,
                                        device=device, uninitialized=True)
    num_classes = model.config.num_classes
    model = load_weights(args, model)
    pipeline = EfficientDetPipeline(args.imagePath, args.labelFile, args.classesFile,
                                    args.batchSize, anchors, num_classes, image_size=size,
                                    augment=False, label_mean=False, with_raw_boxes=True,
                                    device=device)
    collect = make_efficientdet_pred_gt(model, anchors, quant=calibrate(args, model, pipeline))
    n = args.maxImages or pipeline.labels_num
    data = []
    batches = iter(pipeline)
    try:
        for bi in range((n + args.batchSize - 1) // args.batchSize):
            for j, (pred, gt) in enumerate(collect(next(batches))):
                if bi * args.batchSize + j >= n:
                    break
                data.append({"image_path": f"{bi * args.batchSize + j}.jpg",
                             "groud_truth": gt.tolist(), "prediction": pred.tolist()})
    finally:
        batches.close()
    return data, num_classes


def eval_efficientdet(args):
    data, num_classes = efficientdet_records(args)
    return {"mAP": score_dataset(data, num_classes, args.mode, args.variant, args.thresh),
            "images": len(data)}


def main(argv=None):
    args = parse_args(argv)
    result = eval_yolo(args) if args.family == "yolo" else eval_efficientdet(args)
    result.update({"family": args.family, "mode": args.mode, "variant": args.variant,
                   "quant": "int8_static" if args.int8Static else "off"})
    if args.int8Static and args.int8Margin != 1.0:
        result["int8_margin"] = args.int8Margin
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
