"""Export a warm detector predictor to a ``torch.export`` serving artifact.

Port of ``tmv_tpu/cli/export_model.py`` with its flags and rules. The whole predict
path (forward, decode and class-aware NMS: the predictor's ``.core``) is traced into
one artifact (``serving/export.py``, baked weights); ``cli/serve.py --artifact``
serves it without building the model. The hand-written kernels are in the program
as the ``tmv::`` custom ops, so the artifact runs the kernels on the card and the
plain versions on the CPU (``--platforms cuda,cpu``, the default).

Usage:
    python -m tmv_tpu_torch.cli.export_model --modelPath ckpt/ --classesFile c.txt \\
        --anchorsFile a.txt --imageSize 640 --bf16 --out yolov4.tmvt
    python -m tmv_tpu_torch.cli.export_model --family efficientdet \\
        --modelName efficientdet-d0 --classesFile c.txt --imageSize 512 --bf16 \\
        --out d0.tmvt

``--modelPath`` is a checkpoint directory of the port's trainers or a ``.pt``
state_dict (``core.checkpoint.load_weights``); without it the port's seeded init
(``--seed``) is exported. ``--int8Static CALIB_DIR`` calibrates over the images of
``CALIB_DIR`` (``quant.static.calibrate_directory``, with ``--int8Margin`` and
``--int8PerChannel``) and exports the static int8 program: the sites' scales and
quantized weights are constants of the program. ``--device cuda`` (the default)
traces on the card and raises where there is none; ``--device cpu`` traces on the CPU.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modelPath", default=None,
                   help="checkpoint directory or .pt state_dict (omit for the seeded init)")
    p.add_argument("--seed", type=int, default=0, help="seed of the init without --modelPath")
    p.add_argument("--family", default="yolo", choices=["yolo", "efficientdet"])
    p.add_argument("--modelName", default="efficientdet-d0",
                   help="EfficientDet config name (--family efficientdet)")
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsFile", default=None,
                   help="anchors csv (required for --family yolo; EfficientDet makes its "
                        "anchors from its config)")
    p.add_argument("--version", default="v4", choices=["v3", "v4", "resnet"],
                   help="'resnet' = the MoCo/distill ResNet50V2 + YOLOv3-head detector")
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated devices the artifact may be loaded for")
    p.add_argument("--confidenceThresh", type=float, default=0.5)
    p.add_argument("--scoresThresh", type=float, default=0.2)
    p.add_argument("--iouThresh", type=float, default=0.5)
    p.add_argument("--int8Static", metavar="CALIB_DIR", default=None,
                   help="bake the static-calibration int8 path into the artifact: calibrate "
                        "activation scales over the images in CALIB_DIR, pre-quantize the "
                        "weights, export the int8 program")
    p.add_argument("--int8Margin", type=float, default=1.0,
                   help="multiplier on the calibrated activation absmax (<1 clips outliers)")
    p.add_argument("--int8PerChannel", action="store_true",
                   help="per-input-channel activation scales")
    args = p.parse_args(argv)
    if args.family == "yolo" and not args.anchorsFile:
        p.error("--anchorsFile is required for --family yolo")
    return args


def live_predictor(args):
    """The live predictor the flags describe, on ``--device`` → ``(batched predictor,
    quant)``: the model built as ``cli/serve.py`` builds it, its weights
    (``--modelPath``, or the seeded init) and its int8 calibration. ``main`` exports
    its ``.core``; a caller can hold the artifact against it."""
    import torch

    from tmv_tpu_torch.cli.serve import _build_model
    from tmv_tpu_torch.core import checkpoint
    from tmv_tpu_torch.data.loaders import load_classes
    from tmv_tpu_torch.models.detector_harness import check_device

    device = check_device(args.device)
    _, classes_num = load_classes(args.classesFile)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    thresholds = dict(confidence=args.confidenceThresh, scores=args.scoresThresh,
                      iou=args.iouThresh)
    model, make_batched, init_weights = _build_model(args, classes_num, dtype, thresholds)
    if args.modelPath:
        step = checkpoint.load_weights(model, args.modelPath)
        if step is not None:
            print(f"checkpoint at step {step}", flush=True)
    else:
        init_weights(model, args.seed)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    quant = "off"
    if args.int8Static:
        from tmv_tpu_torch.quant.static import calibrate_directory

        print(f"calibrating int8 scales from {args.int8Static}...", flush=True)
        calibrate_directory(model, args.int8Static, (args.imageSize, args.imageSize),
                            margin=args.int8Margin, per_channel=args.int8PerChannel)
        quant = "int8_static"
    return make_batched(quant), quant


def main(argv=None) -> dict:
    """Export as the flags say → the artifact's META."""
    import numpy as np

    from tmv_tpu_torch.data.loaders import load_classes
    from tmv_tpu_torch.serving.export import export_predictor, read_export_meta

    args = parse_args(argv)
    predict, quant = live_predictor(args)
    _, classes_num = load_classes(args.classesFile)
    version = args.modelName if args.family == "efficientdet" else args.version
    example = np.zeros((1, args.imageSize, args.imageSize, 3), np.float32)
    blob = export_predictor(
        predict, None, example, path=args.out, bake_variables=True,
        platforms=tuple(args.platforms.split(",")),
        meta={"image_size": args.imageSize, "version": version, "classes_num": classes_num,
              "quant": quant, "family": args.family})
    print(f"wrote {args.out}: {len(blob) / 1e6:.2f} MB (classes={classes_num}, {version} "
          f"@{args.imageSize}, {'bf16' if args.bf16 else 'f32'}, quant {quant}, traced on "
          f"{args.device})", flush=True)
    return read_export_meta(args.out)


if __name__ == "__main__":
    main()
