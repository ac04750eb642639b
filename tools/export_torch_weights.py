"""Convert a JAX YOLOv4 checkpoint into the ``.pt`` state_dict the PyTorch port serves.

Restores the orbax checkpoint through ``tmv_tpu.core.checkpoint.CheckpointManager``
as ``tmv_tpu/cli/serve.py`` does, maps its flax tree with
``tmv_tpu_torch.convert.flax_bridge``, loads it strictly into the port's
``YoloV4`` and saves that module's ``state_dict``.

Usage:
    python tools/export_torch_weights.py --modelPath ./data/yolo_weights \\
        --classesFile ./data/classes.txt --out yolov4.pt
    python -m tmv_tpu_torch.cli.serve --modelPath yolov4.pt --classesFile ... \\
        --anchorsFile ... --imageSize 640
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(model_path: str, classes_num: int, out: str, anchors_per_scale: int = 3,
           step=None) -> int:
    """Write ``out`` and return the checkpoint step it came from."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from tmv_tpu.core.checkpoint import CheckpointManager
    from tmv_tpu.core.train_state import TrainState
    from tmv_tpu.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
    from tmv_tpu_torch.models.detector_harness import build_yolo_model as build_torch

    if not os.path.isdir(model_path):
        raise FileNotFoundError(f"no checkpoint directory at {model_path}")
    model, _ = build_yolo_model("v4", classes_num, anchors_per_scale)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = TrainState.create(template["params"], template["batch_stats"], optax.sgd(1e-3))
    mgr = CheckpointManager(model_path)
    if mgr.latest_step() is None:
        raise FileNotFoundError(f"{model_path} holds no checkpoint")
    state = mgr.restore_weights(state, step)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    net, _ = build_torch("v4", classes_num, anchors_per_scale, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    torch.save(net.state_dict(), out)
    return int(state.step)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modelPath", required=True, help="orbax checkpoint directory")
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsPerScale", type=int, default=3)
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    p.add_argument("--out", required=True, help="output .pt path")
    args = p.parse_args(argv)

    from tmv_tpu.data.loaders import load_classes

    _, classes_num = load_classes(args.classesFile)
    step = export(args.modelPath, classes_num, args.out, args.anchorsPerScale, args.step)
    print(f"wrote {args.out} from step {step} ({classes_num} classes)")


if __name__ == "__main__":
    main()
