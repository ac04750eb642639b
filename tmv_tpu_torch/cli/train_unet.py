"""UNet keypoint-heatmap training CLI on one GPU.

Port of ``tmv_tpu/cli/train_unet.py`` (the reference's `unet/train.py:20-115`):
labelme 4-corner labels (``data/unet_dataset.py``, host augmentation drawn from
seeded ``random``/numpy generators, Gaussian heatmap targets), ``UNetLogits``
at ``--depth`` and ``--filtersBase`` with ``--pointsNum`` output channels,
float32, the mean sigmoid cross-entropy, Adam at ``--lr`` with a global-norm
clip of 10 (``core/train_state.py::make_train_step``), checkpoint resume with
the step, and every ``--dumpEvery`` steps an asynchronous save, the
ReduceLROnPlateau and EarlyStopping windows, and the input, target and
prediction dumps of the batch's first image under ``<modelPath>/dumps``.
GracefulShutdown checkpoints on SIGTERM/SIGINT; a final save ends the run.
``--remat`` recomputes each encoder and decoder stage in the backward. Batches
are built on a producer thread and copied to the card from pinned memory.
``--device cuda`` (the default) raises where there is no GPU; ``--device cpu``
is for tests.

Usage:
    python -m tmv_tpu_torch.cli.train_unet --labelPath ./train_data/json \\
        --inputSize 128 --depth 4 --filtersBase 16 --pointsNum 4 --batchSize 4
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--labelPath", required=True, help="dir with labelme *.json + images")
    p.add_argument("--batchSize", type=int, default=4)
    p.add_argument("--inputSize", type=int, default=128)
    p.add_argument("--pointsNum", type=int, default=4)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--modelPath", default="./data/unet_weights")
    p.add_argument("--dumpEvery", type=int, default=500)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--filtersBase", type=int, default=16)
    p.add_argument("--earlyStopPatience", type=int, default=10,
                   help="dump windows without loss improvement before stopping (0 disables)")
    p.add_argument("--reduceLrPatience", type=int, default=0,
                   help="flat windows before LR *= 0.1 (0 disables)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each stage in the backward (torch.utils.checkpoint)")
    p.add_argument("--firstShape", action="store_true",
                   help="accept multi-shape labelme files (take the first shape) instead of "
                        "the reference's exactly-one-shape filter")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns ``{"step", "losses"}`` (the raw loss of every step run)."""
    import torch

    from tmv_tpu_torch.core.callbacks import (
        EarlyStopping, GracefulShutdown, ReduceLROnPlateau, set_learning_rate,
    )
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.core.metrics import MetricsLogger, StepTimer
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.efficientdet_pipeline import to_device
    from tmv_tpu_torch.data.prefetch import prefetch_batches
    from tmv_tpu_torch.data.unet_dataset import get_dataset
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.models.unet import UNetLogits, init_weights, make_unet_loss_fn

    args = parse_args(argv)
    device = check_device(args.device)
    size = (args.inputSize, args.inputSize)
    host_batches, gen = get_dataset(args.labelPath, args.batchSize, args.pointsNum, size, size,
                                    first_shape=args.firstShape)
    print(f"{gen.labels_num} labels", flush=True)

    model = UNetLogits(depth=args.depth, filters_base=args.filtersBase,
                       output_filters=args.pointsNum, device=device, remat=args.remat)
    init_weights(model, 0)
    model = model.to(memory_format=torch.channels_last)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    state = TrainState.create(model, optimizer)
    mgr = CheckpointManager(args.modelPath)
    state = mgr.restore(state)
    if state.step:
        print(f"resumed from step {state.step}", flush=True)

    early = EarlyStopping(patience=args.earlyStopPatience) if args.earlyStopPatience else None
    plateau = (ReduceLROnPlateau(factor=0.1, patience=args.reduceLrPatience, base_lr=args.lr)
               if args.reduceLrPatience else None)
    step_fn = make_train_step(make_unet_loss_fn(), clip_global_norm=10.0)
    logger = MetricsLogger(os.path.join(args.modelPath, "metrics.jsonl"), print_every=50)
    timer = StepTimer(batch_size=args.batchSize)
    shutdown = GracefulShutdown()

    def next_batch():
        return {k: to_device(v.numpy(), device) for k, v in next(host_batches).items()}

    window_losses, losses = [], []
    batches = prefetch_batches(next_batch, 2)
    try:
        for i in range(state.step, args.steps):
            batch = next(batches)
            metrics = step_fn(state, batch)
            if shutdown.requested:
                print(f"preemption signal: checkpointing at step {state.step} and exiting",
                      flush=True)
                break
            metrics.update(timer.tick())
            logger.log(i, metrics)
            losses.append(float(metrics["raw_loss"]))
            window_losses.append(float(metrics["loss"]))
            if (i + 1) % args.dumpEvery == 0:
                mgr.save(state.step, state, wait=False)
                window_loss = float(np.mean(window_losses))
                window_losses = []
                if plateau is not None:
                    set_learning_rate(optimizer, plateau.update(window_loss))
                if early is not None and early.update(window_loss):
                    print(f"early stopping: no improvement for {args.earlyStopPatience} "
                          "windows", flush=True)
                    break
                dump(model, batch, os.path.join(args.modelPath, "dumps"), i, args.pointsNum)
    finally:
        batches.close()
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    logger.close()
    return {"step": state.step, "losses": losses}


def dump(model, batch, out_dir: str, step: int, points_num: int):
    """The reference's test-step images (`unet/train.py:63-115`): the batch's
    first input, and per point its target and the eval-mode prediction."""
    import torch

    from tmv_tpu_torch.utils import image_helper

    model.eval()
    try:
        with torch.no_grad():
            pred = torch.sigmoid(model(batch["image"][:1]))[0].float().cpu().numpy()
    finally:
        model.train()
    os.makedirs(out_dir, exist_ok=True)
    image = batch["image"][0].float().cpu().numpy()
    target = batch["target"][0].float().cpu().numpy()
    image_helper.image_to_file(os.path.join(out_dir, f"in_{step}.jpg"), image * 255)
    for c in range(points_num):
        image_helper.image_to_file(os.path.join(out_dir, f"target_{step}_{c}.jpg"),
                                   (target[..., c] * 255)[..., None].repeat(3, -1))
        image_helper.image_to_file(os.path.join(out_dir, f"pred_{step}_{c}.jpg"),
                                   (pred[..., c] * 255)[..., None].repeat(3, -1))


if __name__ == "__main__":
    main()
