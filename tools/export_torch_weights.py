"""Convert a JAX checkpoint into the ``.pt`` state_dict the PyTorch port serves.

Restores the orbax checkpoint through ``tmv_tpu.core.checkpoint.CheckpointManager``
as ``tmv_tpu/cli/serve.py`` does (``restore_weights``: parameters and BatchNorm
statistics, whatever the optimizer was), maps its flax tree with
``tmv_tpu_torch.convert.flax_bridge``, loads it strictly into the port's module
and saves that module's ``state_dict``. ``--family yolo`` takes ``--version v4``
(the default), ``v3`` or ``resnet``; ``--family efficientdet`` takes
``--modelName`` and ``--imageSize`` and sizes the heads as the JAX trainer and
server do (the classes + 1 for the background).

``--family moco`` carries a whole JAX MoCo pretraining state (``cli/train_moco.py``
at ``--imageSize``, ``--outFilters``, ``--queueSize``) into a checkpoint
directory ``--out`` of the port's ``cli/train_moco.py``: the query tower, its
SGD momentum (``optax_sgd_state_dict``), the step, the key tower, the queue and
its pointer (``moco_state_from_flax``), so that the port's pretraining resumes
it. It needs no classes file.

Usage:
    python tools/export_torch_weights.py --modelPath ./data/yolo_weights \\
        --classesFile ./data/classes.txt --out yolov4.pt
    python -m tmv_tpu_torch.cli.serve --modelPath yolov4.pt --classesFile ... \\
        --anchorsFile ... --imageSize 640
    python tools/export_torch_weights.py --family efficientdet --modelName efficientdet-d0 \\
        --imageSize 512 --modelPath ./data/d0_weights --classesFile ./data/classes.txt \\
        --out d0.pt
    python -m tmv_tpu_torch.cli.serve --family efficientdet --modelPath d0.pt \\
        --classesFile ... --imageSize 512
    python tools/export_torch_weights.py --family moco --modelPath ./data/moco_weights \\
        --imageSize 416 --out ./data/moco_weights_torch
    python -m tmv_tpu_torch.cli.train_moco --modelPath ./data/moco_weights_torch
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flax_and_torch(family: str, version: str, classes_num: int, anchors_per_scale: int,
                    model_name: str, image_size: int):
    """(flax module, a dummy input for its init, the port's module on the CPU)."""
    import jax.numpy as jnp

    if family == "efficientdet":
        from tmv_tpu.models.efficientdet import EfficientDetNet
        from tmv_tpu_torch.models.efficientdet.harness import (
            build_efficientdet, efficientdet_config,
        )

        # background reserved at id 0
        cfg = efficientdet_config(model_name, classes_num + 1, image_size)
        net, _ = build_efficientdet(model_name, classes_num + 1, image_size, device="cpu")
        return (EfficientDetNet(config=cfg),
                jnp.zeros((1, image_size, image_size, 3), jnp.float32), net)
    from tmv_tpu.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.detector_harness import build_yolo_model as build_torch

    model, _ = build_yolo_model(version, classes_num, anchors_per_scale)
    net, _ = build_torch(version, classes_num, anchors_per_scale, device="cpu")
    return model, jnp.zeros((1, 64, 64, 3), jnp.float32), net


def export(model_path: str, classes_num: int, out: str, anchors_per_scale: int = 3,
           step=None, family: str = "yolo", version: str = "v4",
           model_name: str = "efficientdet-d0", image_size: int = 512) -> int:
    """Write ``out`` and return the checkpoint step it came from."""
    import jax
    import numpy as np
    import optax
    import torch

    from tmv_tpu.core.checkpoint import CheckpointManager
    from tmv_tpu.core.train_state import TrainState
    from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict

    if not os.path.isdir(model_path):
        raise FileNotFoundError(f"no checkpoint directory at {model_path}")
    model, x0, net = _flax_and_torch(family, version, classes_num, anchors_per_scale,
                                     model_name, image_size)
    shapes = jax.eval_shape(model.init, jax.random.key(0), x0)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = TrainState.create(template["params"], template["batch_stats"], optax.sgd(1e-3))
    mgr = CheckpointManager(model_path)
    if mgr.latest_step() is None:
        raise FileNotFoundError(f"{model_path} holds no checkpoint")
    state = mgr.restore_weights(state, step)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    torch.save(net.state_dict(), out)
    return int(state.step)


def export_moco(model_path: str, out: str, image_size: int = 416, out_filters: int = 21,
                queue_size: int = 100, lr: float = 1e-3, step=None) -> int:
    """Write the port's MoCo checkpoint of the JAX MoCo state in ``model_path``
    into the directory ``out``; returns the step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from tmv_tpu.core.checkpoint import CheckpointManager
    from tmv_tpu.core.train_state import TrainState
    from tmv_tpu.models.moco import ResNetYoloV3, init_moco_state
    from tmv_tpu_torch.convert.flax_bridge import (
        flax_to_state_dict, moco_state_from_flax, optax_sgd_state_dict,
    )
    from tmv_tpu_torch.core.checkpoint import CheckpointManager as TorchCheckpointManager
    from tmv_tpu_torch.core.train_state import TrainState as TorchTrainState
    from tmv_tpu_torch.models.moco import ResNetYoloV3 as TorchResNetYoloV3

    model = ResNetYoloV3(out_filters=out_filters)
    x0 = jnp.zeros((1, image_size, image_size, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), x0)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    heads = jax.eval_shape(model.apply, template, x0)
    dim = sum(int(np.prod(h.shape[1:])) for h in heads)
    tx = optax.sgd(lr, momentum=0.9)
    state = TrainState.create(template["params"], template["batch_stats"], tx,
                              extra=init_moco_state(template, queue_size, dim,
                                                    jax.random.key(1)))
    mgr = CheckpointManager(model_path)
    if mgr.latest_step() is None:
        raise FileNotFoundError(f"{model_path} holds no checkpoint")
    state = mgr.restore(state, step)
    net = TorchResNetYoloV3(out_filters, device="cpu")
    net.load_state_dict(flax_to_state_dict({"params": state.params,
                                            "batch_stats": state.batch_stats}, net),
                        strict=True)
    optimizer = torch.optim.SGD(net.parameters(), lr=lr, momentum=0.9)
    optimizer.load_state_dict(optax_sgd_state_dict(state.opt_state, net, optimizer))
    moco = moco_state_from_flax(state.extra, TorchResNetYoloV3(out_filters, device="cpu"))
    ported = TorchTrainState.create(net, optimizer, extra=moco)
    ported.step = int(state.step)
    ported.shadow_loss = torch.tensor(float(np.asarray(state.shadow_loss)))
    writer = TorchCheckpointManager(out)
    writer.save(ported.step, ported)
    writer.close()
    return ported.step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modelPath", required=True, help="orbax checkpoint directory")
    p.add_argument("--classesFile", default=None,
                   help="needed by the yolo and efficientdet families")
    p.add_argument("--family", default="yolo", choices=["yolo", "efficientdet", "moco"])
    p.add_argument("--version", default="v4", choices=["v3", "v4", "resnet"])
    p.add_argument("--modelName", default="efficientdet-d0")
    p.add_argument("--imageSize", type=int, default=512,
                   help="EfficientDet input size (sizes its pyramid); MoCo's (sizes the queue)")
    p.add_argument("--outFilters", type=int, default=21, help="MoCo's tower heads")
    p.add_argument("--queueSize", type=int, default=100, help="MoCo's queue")
    p.add_argument("--lr", type=float, default=1e-3, help="MoCo's SGD learning rate")
    p.add_argument("--anchorsPerScale", type=int, default=3)
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    p.add_argument("--out", required=True,
                   help="output .pt path (a checkpoint directory for --family moco)")
    args = p.parse_args(argv)
    if args.family == "moco":
        step = export_moco(args.modelPath, args.out, args.imageSize, args.outFilters,
                           args.queueSize, args.lr, args.step)
        print(f"wrote {args.out} from step {step} (MoCo)")
        return
    if args.classesFile is None:
        p.error("--classesFile is required for the yolo and efficientdet families")

    from tmv_tpu.data.loaders import load_classes

    _, classes_num = load_classes(args.classesFile)
    step = export(args.modelPath, classes_num, args.out, args.anchorsPerScale, args.step,
                  args.family, args.version, args.modelName, args.imageSize)
    print(f"wrote {args.out} from step {step} ({classes_num} classes)")


if __name__ == "__main__":
    main()
