"""Serving CLI: a warm detector on one GPU behind the reference HTTP contract.

Port of ``tmv_tpu/cli/serve.py`` for the YOLO family (``--version v4``, DIoU
NMS; ``v3`` and ``resnet``, IoU NMS) and the EfficientDet family (``--family efficientdet --modelName efficientdet-d0``, as
``_serve_efficientdet`` there: ``num_classes`` = classes + 1 for the background,
pyramid levels sized from ``--imageSize``). It serves through the port's own
``serving.app`` (``DetectionService``, ``create_app``, ``run_server``) and
``serving.batching.MicroBatcher``, and warms the predictor before it takes traffic.

Usage:
    python -m tmv_tpu_torch.cli.serve --modelPath yolov4.pt \\
        --classesFile classes.txt --anchorsFile anchors.txt --imageSize 640 --bf16
    python -m tmv_tpu_torch.cli.serve --family efficientdet --modelName efficientdet-d0 \\
        --classesFile classes.txt --imageSize 512 --bf16 --randomInit --seed 0

``--artifact model.tmvt`` serves an export of ``cli/export_model.py`` (JAX
``serve_artifact``): no model is built and no checkpoint loaded; ``--imageSize`` must
be the artifact's, and ``--batch``, the int8 flags, ``--bf16``, ``--modelPath`` and
``--randomInit`` are refused (the program pins them). On the card the artifact runs
the hand-written kernels (the ``tmv::`` ops), with ``--device cpu`` their plain
versions.

``--modelPath`` is a checkpoint directory of the port's trainers or of
``cli/convert_darknet.py`` (the latest step), or a ``.pt`` state_dict of the
port's module (from a JAX checkpoint: ``tools/export_torch_weights.py`` through
the flax bridge), loaded by ``core.checkpoint.load_weights``. ``--randomInit --seed
N`` serves seeded random weights instead, for trying the path without a
checkpoint. ``--device cuda`` (the default) raises where there is no GPU.

``--dp N`` (JAX's data-parallel serving) runs N predictor replicas, one per card
(``cuda:0 … cuda:N−1``; more than the host's cards exits with the reason), under the
micro-batch queue: ``--batch`` > 1 divisible by N, each batch padded to ``--batch``
and split in order over the replicas, each on its own stream and host thread
(``parallel/inference.py``), for both families and with ``--int8Static``.

``--spatial N`` (JAX's latency direction) splits each image's height over N
predictor replicas (``cuda:0 … cuda:N−1``, or N shards on the CPU), each running its
rows on a host thread and stream of its own with hand-written halo exchanges between
them (``parallel/halo.py``); the heads are gathered on the first device and decoded
and swept there once (``parallel/inference.py::make_spatial_predictor``). The JAX
server's rules: ``--batch 1``, no ``--dp``, ``--imageSize`` divisible by N; for both
families, with the int8 flags too.

int8 serving (YOLO family only, as the JAX server): ``--int8Static CALIB_DIR``
calibrates activation scales over the images of ``CALIB_DIR`` (letterboxed, the
first 32), quantizes the weights once (``--int8PerChannel``: per-input-channel
activation scales; ``--int8Margin``: a multiplier on the calibrated absmax) and
serves every ConvBN through the int8 conv kernel; ``--int8`` quantizes dynamically
at each call (batch 1 only). Usage:

    python -m tmv_tpu_torch.cli.serve --modelPath yolov4.pt --classesFile c.txt \
        --anchorsFile a.txt --imageSize 640 --bf16 --int8Static calib/ --int8PerChannel \
        --batch 16
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modelPath", default=None,
                   help="checkpoint directory (latest step) or .pt state_dict of the "
                        "port's module")
    p.add_argument("--randomInit", action="store_true",
                   help="serve seeded random weights (no checkpoint)")
    p.add_argument("--seed", type=int, default=0, help="seed of --randomInit")
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsFile", default=None, help="required for --family yolo")
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch", type=int, default=1,
                   help="micro-batch capacity (>1 enables the batching queue "
                        "and the threaded server)")
    p.add_argument("--batchWaitMs", type=float, default=4.0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--version", default="v4", choices=["v3", "v4", "resnet"])
    p.add_argument("--family", default="yolo", choices=["yolo", "efficientdet"])
    p.add_argument("--modelName", default="efficientdet-d0",
                   help="EfficientDet config name (--family efficientdet)")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 convs (per-call absmax; --batch 1 only)")
    p.add_argument("--int8Static", metavar="CALIB_DIR", default=None,
                   help="static-calibration int8: calibrate activation scales over the "
                        "images in CALIB_DIR, pre-quantize the weights, serve the int8 "
                        "predictor")
    p.add_argument("--int8Margin", type=float, default=1.0,
                   help="multiplier on the calibrated activation absmax (<1 clips outliers)")
    p.add_argument("--int8PerChannel", action="store_true",
                   help="per-input-channel activation scales")
    p.add_argument("--dp", type=int, default=0,
                   help="shard the micro-batch over this many predictor replicas, one per "
                        "card (parallel/inference.py); needs --batch > 1 divisible by it")
    p.add_argument("--spatial", type=int, default=0,
                   help="split each image's height over this many predictor replicas, one "
                        "per card, with halo exchanges (parallel/halo.py); --batch 1")
    p.add_argument("--artifact", default=None,
                   help="serve an export of cli/export_model.py: skips the model build "
                        "and the checkpoint load")
    args = p.parse_args(argv)
    if args.artifact:
        bad = [f for f, on in (("--batch", args.batch > 1), ("--int8", args.int8),
                               ("--int8Static", bool(args.int8Static)), ("--dp", args.dp > 0),
                               ("--spatial", args.spatial > 0), ("--bf16", args.bf16),
                               ("--modelPath", args.modelPath is not None),
                               ("--randomInit", args.randomInit)) if on]
        if bad:
            p.error(f"{', '.join(bad)} cannot be combined with --artifact: the exported "
                    "program pins its own weights, batch size and dtypes at export time")
        return args
    if args.randomInit == (args.modelPath is not None):
        p.error("give exactly one of --modelPath and --randomInit")
    if args.family == "yolo" and args.anchorsFile is None:
        p.error("--anchorsFile is required for --family yolo")
    if args.batch < 1:
        p.error("--batch must be >= 1")
    if args.family == "efficientdet":
        # JAX refuses --int8 and --int8Static here; the two flags that only tune them
        # are refused with them rather than ignored
        bad = [f for f, on in (("--int8", args.int8), ("--int8Static", bool(args.int8Static)),
                               ("--int8Margin", args.int8Margin != 1.0),
                               ("--int8PerChannel", args.int8PerChannel)) if on]
        if bad:
            p.error(f"{', '.join(bad)} are not supported with --family efficientdet (int8 "
                    "serving is yolo-family; see PARITY §6 — D0 measured 0.73x)")
        if args.dp and (args.batch <= 1 or args.batch % args.dp):
            p.error("--dp requires --batch > 1 divisible by it")
        if args.spatial:
            if args.batch > 1 or args.dp:
                p.error("--spatial is the latency direction: --batch 1, no --dp")
            if args.imageSize % args.spatial:
                p.error(f"--imageSize {args.imageSize} is not divisible by --spatial "
                        f"{args.spatial}")
    else:
        if args.int8 and args.int8Static:
            p.error("--int8 and --int8Static are mutually exclusive")
        if args.int8Static and args.version == "v4" and not args.int8PerChannel:
            # measured on the JAX package's converged 256-image run
            # (converged_map_v4.json): per-tensor static int8 takes YOLOv4's mAP
            # from 0.904 to 0.547; outlier Mish activations in the PAN layers
            # dominate the per-tensor absmax (int8_v4_probe.json)
            print("WARNING: --int8Static with per-TENSOR scales loses ~0.36 mAP on YOLOv4 "
                  "(0.904 -> 0.547 measured, converged_map_v4.json). Add --int8PerChannel, "
                  "or use bf16 for v4.", flush=True)
        if args.int8 and args.batch > 1:
            p.error("--int8 (dynamic) is only supported with --batch 1; use --int8Static "
                    "for batched throughput serving")
        if args.dp:
            if args.batch <= 1:
                p.error("--dp requires --batch > 1 (the sharded predictor serves the "
                        "micro-batch queue)")
            if args.batch % args.dp:
                p.error(f"--batch {args.batch} is not divisible by --dp {args.dp}")
        if args.spatial:
            if args.batch > 1 or args.dp:
                p.error("--spatial is the latency direction: --batch 1, no --dp (combine via "
                        "a 2-D mesh is future work)")
            if args.imageSize % args.spatial:
                p.error(f"--imageSize {args.imageSize} is not divisible by --spatial "
                        f"{args.spatial}")
    return args


def quant_of(args) -> str:
    """The predictors' ``quant`` mode the int8 flags ask for (``off`` for argument
    sets without them: ``cli/detect.py``, ``serving/wsgi.py``)."""
    if getattr(args, "int8Static", None):
        return "int8_static"
    return "int8" if getattr(args, "int8", False) else "off"


def _build_model(args, classes_num, dtype, thresholds=None):
    """``(model, make_batched, init)`` of the family: the module (its weights without
    values: the caller loads them or seeds them with ``init``), a factory of its
    batched predictor (``make_batched(quant)``, or ``make_batched(quant, replica)`` for
    a copy of the module) and its seeded init.
    ``thresholds`` (``confidence``, ``scores``, ``iou``) replace the server's (the
    JAX server's 0.5, 0.2, 0.5 for YOLO; the predictor's own for EfficientDet)."""
    if args.family == "efficientdet":
        from tmv_tpu_torch.models.efficientdet.harness import (
            build_efficientdet, make_efficientdet_predict_batched,
        )
        from tmv_tpu_torch.models.efficientdet.net import init_weights

        # background reserved at id 0
        # every weight is loaded or seeded next (build_service, export_model)
        model, anchors = build_efficientdet(args.modelName, classes_num + 1, args.imageSize,
                                            dtype=dtype, device=args.device, uninitialized=True)
        kw = ({} if thresholds is None else
              dict(iou_threshold=thresholds["iou"], score_threshold=thresholds["scores"]))
        return (model,
                lambda quant, module=model: make_efficientdet_predict_batched(
                    module, anchors, args.imageSize, quant=quant, **kw),
                init_weights)

    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_predict_batched
    from tmv_tpu_torch.models.layers.common import init_weights

    anchors = load_anchors(args.anchorsFile)
    model, iou_type = build_yolo_model(args.version, classes_num, anchors.shape[1], dtype=dtype,
                                       device=args.device, uninitialized=True)
    image_wh = (args.imageSize, args.imageSize)
    t = thresholds or dict(confidence=0.5, scores=0.2, iou=0.5)
    kw = dict(confidence_thresh=t["confidence"], scores_thresh=t["scores"], iou_thresh=t["iou"],
              iou_type=iou_type)
    return (model, lambda quant, module=model: make_yolo_predict_batched(
        module, image_wh, anchors, classes_num, quant=quant, **kw), init_weights)


def artifact_service(args):
    """``serve --artifact`` (JAX ``cli/serve.py::serve_artifact``): the artifact
    loaded on ``--device`` and warmed → a ``DetectionService`` with ``variables=None``.
    Refuses an ``--imageSize`` other than the artifact's and an unbaked artifact."""
    import numpy as np

    from tmv_tpu_torch.data.loaders import load_classes
    from tmv_tpu_torch.serving.app import DetectionService
    from tmv_tpu_torch.serving.export import load_predictor, read_export_meta

    classes_name, _ = load_classes(args.classesFile)
    meta = read_export_meta(args.artifact)
    if meta.get("image_size") and meta["image_size"] != args.imageSize:
        raise SystemExit(
            f"--imageSize {args.imageSize} does not match the artifact (exported at "
            f"{meta['image_size']} px, shape {meta.get('input_shape')}); pass "
            f"--imageSize {meta['image_size']}")
    image_wh = (args.imageSize, args.imageSize)
    predict_fn = load_predictor(args.artifact, device=args.device)
    if not predict_fn.baked:
        raise SystemExit(f"{args.artifact} is unbaked: it takes the weights at call time; "
                         "serve a baked export (cli/export_model.py bakes)")
    predict_fn(None, np.zeros((1, image_wh[1], image_wh[0], 3), np.float32))
    print(f"artifact predictor warm on {args.device} ({meta.get('family', 'yolo')} "
          f"{meta.get('version')}, quant {meta.get('quant')})", flush=True)
    return DetectionService(predict_fn, None, classes_name, image_wh)


def build_service(args, thresholds=None, devices=None):
    """Model, weights and warm predictor → ``(service, model)``: a
    ``DetectionService`` ready for ``create_app``/``run_server`` (its
    ``batcher`` is set when ``--batch`` > 1) and the module it serves (None for
    ``--artifact``, which builds no model).
    ``thresholds`` as in ``_build_model`` (``cli/detect.py`` passes its own).
    ``devices`` replaces the ``--dp``/``--spatial`` replicas' cards (``cuda:0`` twice
    shares one card between two replicas)."""
    import numpy as np
    import torch

    from tmv_tpu_torch.core import checkpoint
    from tmv_tpu_torch.data.loaders import load_classes
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.serving.app import DetectionService

    device = check_device(args.device)
    for flag in ("dp", "spatial"):
        if getattr(args, flag, 0) and devices is None:
            from tmv_tpu_torch.parallel.inference import replica_devices

            try:   # before the model is built: more replicas than cards stop here
                replica_devices(getattr(args, flag), device=args.device)
            except ValueError as e:
                raise SystemExit(f"--{flag} {getattr(args, flag)}: {e}")
    if getattr(args, "artifact", None):
        service = artifact_service(args)
        service.batcher = None
        return service, None
    classes_name, classes_num = load_classes(args.classesFile)
    image_wh = (args.imageSize, args.imageSize)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, make_batched, init_weights = _build_model(args, classes_num, dtype, thresholds)
    if args.randomInit:
        print(f"WARNING: serving random weights (--randomInit --seed {args.seed}); "
              "the boxes mean nothing", flush=True)
        init_weights(model, args.seed)
    else:
        step = checkpoint.load_weights(model, args.modelPath)
        if step is not None:
            print(f"checkpoint at step {step}", flush=True)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    quant = quant_of(args)
    if quant == "int8_static":
        from tmv_tpu_torch.quant.static import calibrate_directory

        print(f"calibrating int8 scales from {args.int8Static}...", flush=True)
        try:
            calibrate_directory(model, args.int8Static, image_wh, margin=args.int8Margin,
                                per_channel=args.int8PerChannel)
        except ValueError as e:
            raise SystemExit(f"--int8Static: {e}")
        print("int8 calibration done", flush=True)

    batched = make_batched(quant)
    if getattr(args, "dp", 0):
        from tmv_tpu_torch.parallel.inference import make_sharded_batched_predictor

        batched, _, devices = make_sharded_batched_predictor(
            model, lambda replica: make_batched(quant, replica), args.dp, devices=devices,
            device=args.device)
        print(f"data-parallel serving over {len(devices)} replicas "
              f"({', '.join(map(str, devices))})", flush=True)
    if getattr(args, "spatial", 0):
        from tmv_tpu_torch.parallel.inference import make_spatial_predictor

        batched, _, devices = make_spatial_predictor(
            model, lambda forward: make_batched(quant, forward), args.spatial,
            devices=devices, device=args.device)
        print(f"spatial serving over {len(devices)} devices "
              f"({', '.join(map(str, devices))})", flush=True)
    batcher = None
    # warm before accepting traffic (import-time parity)
    batched(None, np.zeros((args.batch, image_wh[1], image_wh[0], 3), np.float32))
    if args.batch > 1:
        from tmv_tpu_torch.serving.batching import MicroBatcher

        batcher = MicroBatcher(batched, None, max_batch=args.batch,
                               max_wait_ms=args.batchWaitMs)
        predict_fn = batcher.as_predict_fn()
    else:
        def predict_fn(variables, image):
            return tuple(o[0] for o in batched(variables, image))
    print(f"predictor warm on {device} ({dtype}, quant {quant})", flush=True)
    service = DetectionService(predict_fn, None, classes_name, image_wh)
    service.batcher = batcher
    return service, model


def build_app(args, devices=None):
    """``build_service`` behind the reference's WSGI routes → ``(app, service,
    model)``, for a caller that runs its own WSGI server."""
    from tmv_tpu_torch.serving.app import create_app

    service, model = build_service(args, devices=devices)
    return create_app(service), service, model


def serve_artifact(args):
    """``--artifact``: ``artifact_service`` behind the reference's HTTP routes."""
    from tmv_tpu_torch.serving.app import run_server

    run_server(artifact_service(args), args.host, args.port)


def main(argv=None):
    from tmv_tpu_torch.serving.app import run_server

    args = parse_args(argv)
    if args.artifact:
        return serve_artifact(args)
    service, _ = build_service(args)
    run_server(service, args.host, args.port, threaded=args.batch > 1)


if __name__ == "__main__":
    main()
