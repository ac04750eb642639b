"""Single-image detection CLI: load a checkpoint, predict, draw, save.

Port of ``tmv_tpu/cli/detect.py`` (the reference's `yolo_v4/test.py:28-112`):
letterbox, predict, un-letterbox, draw the boxes with class and score, and
write the result image. ``--family yolo`` (``--version v4``, DIoU NMS; ``v3``
and ``resnet``, IoU NMS) or ``--family efficientdet`` (decode, background
filter, DIoU NMS at ``--iouThresh`` and ``--scoresThresh``). The model is
built, loaded (``core/checkpoint.py::load_weights``: a port checkpoint
directory or a ``.pt``) and served by ``cli/serve.py::build_service``'s code;
the boxes go through the NMS kernel on the card, and for EfficientDet the
forward through the depthwise kernel. ``--device cuda`` (the default) raises
where there is no GPU. The model runs in float32, as the JAX CLI's does.

Usage:
    python -m tmv_tpu_torch.cli.detect --image in.jpg --out result.jpg \\
        --modelPath ./data/yolo_weights --classesFile classes.txt \\
        --anchorsFile anchors.txt --imageSize 416
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="./result.jpg")
    p.add_argument("--modelPath", required=True,
                   help="checkpoint directory (latest step) or .pt state_dict of the port")
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsFile", default=None,
                   help="anchors csv (required for --family yolo; efficientdet makes its "
                        "anchors from its config)")
    p.add_argument("--family", default="yolo", choices=["yolo", "efficientdet"])
    p.add_argument("--modelName", default="efficientdet-d0",
                   help="EfficientDet config name (--family efficientdet)")
    p.add_argument("--version", default="v4", choices=["v3", "v4", "resnet"])
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--confidenceThresh", type=float, default=0.5)
    p.add_argument("--scoresThresh", type=float, default=0.2)
    p.add_argument("--iouThresh", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.family == "yolo" and not args.anchorsFile:
        p.error("--anchorsFile is required for --family yolo")
    return args


def main(argv=None):
    """Detect; returns ``(boxes, class_ids, scores)`` in the image's pixels."""
    from tmv_tpu_torch.cli.serve import build_service
    from tmv_tpu_torch.utils import image_helper

    args = parse_args(argv)
    serve_args = argparse.Namespace(**vars(args), randomInit=False, seed=0, bf16=False,
                                    batch=1, batchWaitMs=4.0)
    service, _ = build_service(serve_args, thresholds=dict(
        confidence=args.confidenceThresh, scores=args.scoresThresh, iou=args.iouThresh))
    with open(args.image, "rb") as f:
        img = image_helper.bytes_to_image(f.read())
    boxes, ids, scores, _ = service.predict_image(img)
    labels = [service.classes_name[i] for i in ids]
    for box, label, score in zip(boxes, labels, scores):
        print(f"{label} {score:.3f} {box.tolist()}")
    image_helper.image_to_file(args.out, image_helper.draw_boxes(img, boxes, labels, scores))
    print(f"wrote {args.out}", flush=True)
    return boxes, ids, scores


if __name__ == "__main__":
    main()
