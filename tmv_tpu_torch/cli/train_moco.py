"""MoCo pretraining, key-tower export and detection fine-tune on one GPU.

Port of ``tmv_tpu/cli/train_moco.py`` (the reference's
`momentum_contrast/train.py`, `save_model.py` and `train_object_detection.py`),
with the JAX CLI's flags and defaults:

- ``--mode pretrain``: ``ResNetYoloV3(--outFilters)`` query and key towers, a
  queue of ``--queueSize`` keys (``models/moco.py``), SGD at ``--lr`` with
  momentum 0.9, the InfoNCE step on two augmented crops of each image
  (``two_crop_batches``, built on a producer thread), a checkpoint every 1000
  steps and at the end holding the query state, the key tower, the queue and
  its pointer; a run restored from ``--modelPath`` continues to ``--steps``;
- ``--mode export_k``: the key tower of the latest ``--modelPath`` checkpoint
  as a weights-only checkpoint in ``--exportPath``
  (``core/checkpoint.py::load_weights`` reads it);
- ``--mode finetune``: a ``ResNetYoloV3`` detector with ``3·(5 + classes)``
  output filters takes every tensor of the exported tower whose name and shape
  match (``convert/graft.py``; the three output convs' weights and biases stay
  fresh), then trains with the CIoU YOLO loss, Adam at ``--lr`` and the shadow
  loss on ``data/yolo_pipeline.py``, checkpointing to ``--modelPath``.

The weights are seeded by ``--seed`` (``layers.common.init_weights``), the queue
by a ``torch.Generator`` seeded by ``--seed`` + 1 on the device (JAX draws it
from ``jax.random.key(1)``); the crops come from ``np.random.default_rng(--seed)``
as the JAX CLI's from seed 0. ``--remat`` recomputes ResNet50V2's blocks and the
neck's stages in the backward. ``--device cuda`` (the default) raises where
there is no GPU; ``--device cpu`` is for tests.

Usage:
    python -m tmv_tpu_torch.cli.train_moco --mode pretrain --trainImagePath ./imgs
    python -m tmv_tpu_torch.cli.train_moco --mode export_k
    python -m tmv_tpu_torch.cli.train_moco --mode finetune --trainImagePath ./imgs \\
        --trainData ./labels.txt --classesFile ./classes.txt --anchorsFile ./anchors.txt \\
        --modelPath ./data/moco_detector
"""

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="pretrain", choices=["pretrain", "export_k", "finetune"])
    p.add_argument("--trainImagePath", required=False)
    p.add_argument("--trainData", required=False)
    p.add_argument("--classesFile", required=False)
    p.add_argument("--anchorsFile", required=False)
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--queueSize", type=int, default=100)
    p.add_argument("--outFilters", type=int, default=21)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--modelPath", default="./data/moco_weights")
    p.add_argument("--exportPath", default="./data/moco_k_weights")
    p.add_argument("--remat", action="store_true",
                   help="recompute each stage in the backward (torch.utils.checkpoint)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def two_crop_batches(image_path: str, batch_size: int, image_size: int, seed: int = 0):
    """Endless ``{"query", "key"}`` batches of ``(B, S, S, 3)`` float32 numpy
    images in [0, 1]: two independent augmentations of each drawn image (blur
    at probability 0.5, colour jitter, noise, a left-right flip at probability
    0.5, proportional resize; `moco_dataset.py:13-153`). The same files and
    seed give the JAX CLI's arrays bit for bit."""
    from tmv_tpu_torch.utils import image_helper
    from tmv_tpu_torch.utils.file_helper import read_file_list

    files = read_file_list(image_path, r"\.(jpg|jpeg|png)$")
    if not files:
        raise FileNotFoundError(f"no jpg/jpeg/png image under {image_path}")
    rng = np.random.default_rng(seed)

    def aug(img):
        out = img
        if rng.random() < 0.5:
            out = image_helper.blur(out, rng.uniform(0.5, 2.0))
        out = image_helper.random_color_jitter(out, rng)
        out = image_helper.random_noise(out, rng, 0.01)
        if rng.random() < 0.5:
            out = out[:, ::-1]
        out, _, _ = image_helper.proportional_resize(out, (image_size, image_size))
        return out.astype(np.float32) / 255.0

    while True:
        q_batch, k_batch = [], []
        for _ in range(batch_size):
            path = files[rng.integers(0, len(files))]
            with open(path, "rb") as f:
                img = image_helper.bytes_to_image(f.read())
            q_batch.append(aug(img))
            k_batch.append(aug(img))
        yield {"query": np.stack(q_batch), "key": np.stack(k_batch)}


def build_tower(out_filters: int, device, remat: bool, seed: int):
    """A seeded ``ResNetYoloV3`` in ``channels_last`` on ``device``."""
    import torch

    from tmv_tpu_torch.models.layers.common import init_weights
    from tmv_tpu_torch.models.moco import ResNetYoloV3

    model = ResNetYoloV3(out_filters, device=device, remat=remat)
    init_weights(model, seed)
    return model.to(memory_format=torch.channels_last)


def moco_train_state(args, device):
    """The pretraining state: the seeded query tower, SGD(lr, momentum 0.9), and
    a ``MocoState`` (key tower, queue of ``--queueSize`` keys of the heads'
    flattened size)."""
    import torch

    from tmv_tpu_torch.core.train_state import TrainState
    from tmv_tpu_torch.models.moco import init_moco_state

    model = build_tower(args.outFilters, device, args.remat, args.seed)
    s = args.imageSize
    with torch.no_grad():
        heads = model.eval()(torch.zeros((1, s, s, 3), device=device))
    dim = sum(int(np.prod(h.shape[1:])) for h in heads)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    extra = init_moco_state(model, args.queueSize, dim, generator=gen)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    return TrainState.create(model, optimizer, extra=extra), dim


def to_device(batch, device):
    import torch

    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}


def pretrain(args, device):
    """The MoCo loop; returns ``{"step", "losses", "feature_dim"}``."""
    from tmv_tpu_torch.core.callbacks import GracefulShutdown
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.data.prefetch import prefetch_batches
    from tmv_tpu_torch.models.moco import make_moco_train_step

    state, dim = moco_train_state(args, device)
    print(f"feature dim {dim}", flush=True)
    mgr = CheckpointManager(args.modelPath)
    state = mgr.restore(state)
    if state.step:
        print(f"resumed from step {state.step}", flush=True)
    step_fn = make_moco_train_step()
    crops = two_crop_batches(args.trainImagePath, args.batchSize, args.imageSize, args.seed)
    batches = prefetch_batches(lambda: to_device(next(crops), device), 2)
    shutdown = GracefulShutdown()
    losses = []
    try:
        for i in range(state.step, args.steps):
            metrics = step_fn(state, next(batches))
            losses.append(metrics["loss"])
            if shutdown.requested:
                print(f"preemption signal: checkpointing at step {state.step} and exiting",
                      flush=True)
                break
            if i % 50 == 0:
                print(f"step {i} loss {float(metrics['loss']):.4f}", flush=True)
            if (i + 1) % 1000 == 0:
                mgr.save(state.step, state, wait=False)
    finally:
        batches.close()
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    return {"step": state.step, "losses": [float(v) for v in losses], "feature_dim": dim}


def export_k(args, device):
    """Write the key tower of ``--modelPath``'s latest checkpoint to
    ``--exportPath`` at that step; returns ``{"step"}``."""
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.core.train_state import TrainState

    state, _ = moco_train_state(args, device)
    mgr = CheckpointManager(args.modelPath)
    if mgr.latest_step() is None:
        raise FileNotFoundError(f"{args.modelPath} holds no checkpoint")
    state = mgr.restore(state)
    mgr.close()
    key = TrainState.create(state.extra.key_model, None)
    key.step = state.step
    out = CheckpointManager(args.exportPath)
    out.save(state.step, key)
    out.close()
    print(f"exported key tower to {args.exportPath}", flush=True)
    return {"step": state.step}


def finetune(args, device):
    """Graft the exported tower into a detector and train it; returns
    ``{"step", "losses", "copied", "skipped"}``."""
    import torch

    from tmv_tpu_torch.convert.graft import graft_params
    from tmv_tpu_torch.core.callbacks import GracefulShutdown
    from tmv_tpu_torch.core.checkpoint import CheckpointManager, read_weights
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.models.detector_harness import make_yolo_loss_fn

    s = args.imageSize
    anchors = load_anchors(args.anchorsFile)
    pipeline = YoloDataPipeline(args.trainImagePath, args.trainData, args.classesFile,
                                args.batchSize, anchors, image_wh=(s, s), device=device)
    model = build_tower(3 * (5 + pipeline.classes_num), device, args.remat, args.seed)
    exported, _ = read_weights(args.exportPath)
    grafted, copied, skipped = graft_params(model.state_dict(), exported)
    model.load_state_dict(grafted, strict=True)
    print(f"grafted {len(copied)} tensors from {args.exportPath}; {len(skipped)} "
          "shape-mismatched (fresh init)", flush=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    state = TrainState.create(model, optimizer)
    mgr = CheckpointManager(args.modelPath)
    state = mgr.restore(state)
    step_fn = make_train_step(make_yolo_loss_fn((s, s), anchors, iou_type="ciou"),
                              shadow_loss=True)
    it = iter(pipeline)
    shutdown = GracefulShutdown()
    losses = []
    try:
        for i in range(state.step, args.steps):
            metrics = step_fn(state, next(it))
            losses.append(metrics["raw_loss"])
            if shutdown.requested:
                print(f"preemption signal: checkpointing at step {state.step} and exiting",
                      flush=True)
                break
            if i % 50 == 0:
                print(f"step {i} loss {float(metrics['loss']):.4f}", flush=True)
            if (i + 1) % 1000 == 0:
                mgr.save(state.step, state, wait=False)
    finally:
        it.close()
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    return {"step": state.step, "losses": [float(v) for v in losses], "copied": copied,
            "skipped": skipped}


def main(argv=None):
    """Run ``--mode``; returns the mode's summary dict."""
    from tmv_tpu_torch.models.detector_harness import check_device

    args = parse_args(argv)
    device = check_device(args.device)
    return {"pretrain": pretrain, "export_k": export_k, "finetune": finetune}[args.mode](
        args, device)


if __name__ == "__main__":
    main()
