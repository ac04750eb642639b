"""Weight-import CLI: Darknet ``.weights`` / Keras ``.h5`` → port checkpoint.

Port of ``tmv_tpu/cli/convert_darknet.py`` (the reference's `yolo_v3/convert.py`
+ `convert_tf2.py` and their yolo_v4 twins in one step): the weights go into
the port's YOLOv3/YOLOv4 (``convert.darknet`` / ``convert.h5_import``), or into
a model built from a Darknet ``--cfg`` (``convert.darknet_cfg``), and a
weights-only checkpoint at step 0 is written to ``--out``
(``core/checkpoint.py``), a directory that ``cli/serve.py``, ``cli/eval_map.py``
and ``cli/train_yolo.py`` take as ``--modelPath``. ``--device cuda`` (the
default) raises where there is no GPU.

Usage:
    python -m tmv_tpu_torch.cli.convert_darknet --weights yolov3.weights \\
        --version v3 --classesNum 80 --out ./weights/yolov3
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", required=True, help="darknet .weights or keras .h5 file")
    p.add_argument("--version", default="v4", choices=["v3", "v4"])
    p.add_argument("--cfg", default=None,
                   help="darknet .cfg: build the model from config instead of the built-in "
                        "architectures")
    p.add_argument("--classesNum", type=int, default=80)
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--out", required=True, help="checkpoint dir")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Convert; returns the converted model."""
    from tmv_tpu_torch.convert.darknet import load_darknet_weights
    from tmv_tpu_torch.convert.h5_import import load_keras_h5_weights
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.core.train_state import TrainState
    from tmv_tpu_torch.models.detector_harness import build_yolo_model

    args = parse_args(argv)
    if args.cfg:
        from tmv_tpu_torch.convert.darknet_cfg import build_from_cfg

        model, input_size = build_from_cfg(args.cfg, device=args.device)
    else:
        model, _ = build_yolo_model(args.version, args.classesNum, device=args.device)
        input_size = (args.imageSize, args.imageSize)
    if args.weights.endswith((".h5", ".hdf5")):
        skipped = load_keras_h5_weights(model, args.weights, input_size=input_size)
        for i, key, got, want in skipped:
            print(f"skip: h5 layer {i} → {key} (h5 {got} vs model {want})")
    else:
        load_darknet_weights(model, args.weights, input_size=input_size)
    mgr = CheckpointManager(args.out)
    mgr.save(0, TrainState.create(model, None))
    mgr.close()
    print(f"converted {args.weights} → {args.out}")
    return model


if __name__ == "__main__":
    main()
