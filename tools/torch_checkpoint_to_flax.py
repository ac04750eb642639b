"""Carry a checkpoint of the PyTorch port back into flax and score it with the JAX
package's int8 eval.

The port's checkpoint (a directory of its trainers, or a ``.pt`` state_dict; read by
``tmv_tpu_torch.core.checkpoint.load_weights`` into the port's module on the CPU) goes
through ``tmv_tpu_torch.convert.flax_bridge.state_dict_to_flax``, the reverse of the
bridge the port loads JAX weights with. The tree is then held to the JAX model's own
``jax.eval_shape`` tree (the same leaves, shapes and float32), saved as a JAX
checkpoint (``tmv_tpu.core.checkpoint.CheckpointManager``, weights and an SGD state
that ``restore_weights`` ignores) under ``--out``, and scored by the JAX
``tmv_tpu.cli.eval_map`` on the CPU with the converged recipes' settings (global
``mAP_ref``, confidence 0.2 and score 0.05 for YOLO, batches of 8): by default in
float and through ``--int8Static``, per tensor and per channel. Every eval's JSON line is collected
into ``--json`` (the card's host has no JAX, so this runs where JAX does).

    python tools/torch_checkpoint_to_flax.py --modelPath work/ckpt --version v4 \\
        --classesFile c.txt --anchorsFile a.txt --imagePath imgs --labelFile l.txt \\
        --imageSize 416 --out work/flax_ckpt --json scores.json

``--family efficientdet --modelName efficientdet-d0`` carries a D0 checkpoint (its
heads sized for the classes + 1, as the trainers do). ``--passes`` picks the evals
(``float``, ``int8``, ``int8_per_channel``; ``none`` only converts).
"""

import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PASSES = {"float": [], "int8": ["--int8Static"],
          "int8_per_channel": ["--int8Static", "--int8PerChannel"]}


def flax_variables(model_path: str, family: str, version: str, classes_num: int,
                   anchors_per_scale: int, model_name: str, image_size: int):
    """``(step, variables)``: the port's checkpoint as a flax tree, checked leaf by
    leaf against the flax module's ``eval_shape`` tree."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tmv_tpu_torch.convert.flax_bridge import state_dict_to_flax
    from tmv_tpu_torch.core.checkpoint import load_weights

    if family == "efficientdet":
        from tmv_tpu.models.efficientdet import EfficientDetNet
        from tmv_tpu_torch.models.efficientdet.harness import (
            build_efficientdet, efficientdet_config,
        )

        cfg = efficientdet_config(model_name, classes_num + 1, image_size)
        flax_model = EfficientDetNet(config=cfg)
        net, _ = build_efficientdet(model_name, classes_num + 1, image_size, device="cpu")
    else:
        from tmv_tpu.models.detector_harness import build_yolo_model
        from tmv_tpu_torch.models.detector_harness import build_yolo_model as build_torch

        flax_model, _ = build_yolo_model(version, classes_num, anchors_per_scale)
        net, _ = build_torch(version, classes_num, anchors_per_scale, device="cpu")
    step = load_weights(net, model_path)
    variables = state_dict_to_flax(net.state_dict())
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0),
                            jnp.zeros((1, image_size, image_size, 3), jnp.float32))
    want = {path: s for path, s in jax.tree_util.tree_flatten_with_path(dict(shapes))[0]}
    got = {path: a for path, a in jax.tree_util.tree_flatten_with_path(variables)[0]}
    if set(want) != set(got):
        raise KeyError(f"the flax tree differs from the model's: missing "
                       f"{sorted(map(str, set(want) - set(got)))[:5]}, unexpected "
                       f"{sorted(map(str, set(got) - set(want)))[:5]}")
    for path, s in want.items():
        if tuple(got[path].shape) != tuple(s.shape) or s.dtype != np.float32:
            raise ValueError(f"{jax.tree_util.keystr(path)}: {got[path].shape} against the "
                             f"model's {s.shape} {s.dtype}")
    return step, variables


def save_flax_checkpoint(out: str, step: int, variables):
    """A JAX checkpoint directory ``out`` holding ``variables`` at ``step``."""
    import jax.numpy as jnp
    import optax

    from tmv_tpu.core.checkpoint import CheckpointManager
    from tmv_tpu.core.train_state import TrainState

    state = TrainState.create(variables["params"], variables["batch_stats"], optax.sgd(1e-3))
    state = state.replace(step=jnp.asarray(step, state.step.dtype))
    mgr = CheckpointManager(out)
    mgr.save(step, state, force=True)
    mgr.wait_until_finished()
    mgr.close()


def jax_eval(argv) -> dict:
    """``tmv_tpu.cli.eval_map`` with ``argv`` → its JSON line as a dict."""
    from tmv_tpu.cli import eval_map

    saved = sys.argv
    sys.argv = ["eval_map"] + list(argv)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            eval_map.main()
    finally:
        sys.argv = saved
    print(out.getvalue(), end="", flush=True)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modelPath", required=True,
                   help="the port's checkpoint directory (latest step) or .pt state_dict")
    p.add_argument("--family", default="yolo", choices=["yolo", "efficientdet"])
    p.add_argument("--version", default="v4", choices=["v3", "v4", "resnet"])
    p.add_argument("--modelName", default="efficientdet-d0")
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsFile", default=None)
    p.add_argument("--imagePath", default=None)
    p.add_argument("--labelFile", default=None)
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--passes", default="float,int8,int8_per_channel",
                   help="comma-separated: float, int8, int8_per_channel; or none")
    p.add_argument("--out", required=True, help="the JAX checkpoint directory to write")
    p.add_argument("--json", default=None, help="write the evals' results here")
    args = p.parse_args(argv)
    passes = [] if args.passes == "none" else args.passes.split(",")
    if set(passes) - set(PASSES):
        p.error(f"unknown passes {sorted(set(passes) - set(PASSES))}")
    if args.family == "yolo" and not args.anchorsFile:
        p.error("--anchorsFile is required for --family yolo")
    if passes and not (args.imagePath and args.labelFile):
        p.error("--imagePath and --labelFile are required to score")

    from tmv_tpu_torch.data.loaders import load_anchors, load_classes

    _, classes_num = load_classes(args.classesFile)
    per_scale = load_anchors(args.anchorsFile).shape[1] if args.anchorsFile else 3
    step, variables = flax_variables(args.modelPath, args.family, args.version,
                                        classes_num, per_scale, args.modelName, args.imageSize)
    step = int(step or 0)
    save_flax_checkpoint(os.path.abspath(args.out), step, variables)
    print(f"wrote the JAX checkpoint {args.out} at step {step}", flush=True)
    common = ["--family", args.family, "--modelPath", os.path.abspath(args.out),
              "--classesFile", args.classesFile, "--imagePath", str(args.imagePath),
              "--labelFile", str(args.labelFile), "--imageSize", str(args.imageSize),
              "--batchSize", "8", "--mode", "global"]
    if args.family == "yolo":
        common += ["--version", args.version, "--anchorsFile", args.anchorsFile,
                   "--confidenceThresh", "0.2", "--scoresThresh", "0.05"]
    else:
        common += ["--modelName", args.modelName]
    results = {"model_path": args.modelPath, "step": step, "family": args.family,
               "version": args.modelName if args.family == "efficientdet" else args.version,
               "passes": {name: jax_eval(common + PASSES[name]) for name in passes}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
