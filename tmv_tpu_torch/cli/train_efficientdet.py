"""EfficientDet training CLI on one GPU.

Port of ``tmv_tpu/cli/train_efficientdet.py`` on one device: the model config by
name (``--imageSize`` overrides its size), a head of the dataset's classes + 1
(background), the class prior bias, the train pipeline (host augmentation, or
``--deviceAug``), SGD with momentum 0.9 on the cosine schedule with one epoch of
linear warmup from 0.008, its peak ``0.08 · batch / 64``, a global-norm clip of
10, a weight EMA of 0.9998 (parameters only), ``--accumSteps``, checkpoint
resume with the step, a per-epoch asynchronous save, EarlyStopping on the epoch
loss, GracefulShutdown, ``metrics.jsonl`` and a final save. ``--bf16`` trains
bf16 activations on float32 master weights and float32 momentum. The heads'
``drop_connect`` draws from a ``torch.Generator`` on the device seeded with the
step's number, as the JAX CLI's draws come from ``jax.random.key(step)``, so a
resumed run draws what the uninterrupted one would. ``--remat`` recomputes
each MBConv block, BiFPN cell and head in the backward (the heads' recompute
draws the same masks); ``--cacheDir`` (with ``--deviceAug`` only) keeps the
decoded, letterboxed frames in a memmap cache that later epochs read.
``--device cuda`` (the default) raises where there is no GPU; ``--device cpu``
is for tests.

``--dp`` (DDP), ``--fsdp`` (FSDP2) and ``--sp N`` (the image height split over N
ranks, ``parallel.spatial``) train over every visible card with the JAX CLI's rules,
as ``cli/train_yolo.py`` does: ``--batchSize`` is the global batch (the peak learning
rate scales with it), each rank decodes and trains its data rows, the
``drop_connect`` draws are the global batch's; rank 0 alone logs and writes.

Usage:
    python -m tmv_tpu_torch.cli.train_efficientdet --modelName efficientdet-d0 \\
        --trainData ./data/train_labels.txt --trainImagePath ./imgs \\
        --classesFile ./data/classes.txt --imageSize 512 --batchSize 16 --deviceAug

Checkpoints are ``<modelPath>/<step>.pt`` (``core/checkpoint.py``), with
``metrics.jsonl`` beside them; ``cli/eval_map.py --family efficientdet`` scores
them.
"""

import argparse
import os

import numpy as np

from tmv_tpu_torch.cli.train_yolo import check_parallel_flags, parallel_mode, rank_rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modelName", default="efficientdet-d1")
    p.add_argument("--trainData", required=True)
    p.add_argument("--trainImagePath", required=True)
    p.add_argument("--classesFile", required=True)
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--stepsPerEpoch", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--modelPath", default="./data/efficientdet_weights")
    p.add_argument("--maxBoxes", type=int, default=100)
    p.add_argument("--imageSize", type=int, default=0,
                   help="override the config's image size (0 = config)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--accumSteps", type=int, default=1,
                   help="gradient accumulation micro-steps (batchSize must divide)")
    p.add_argument("--remat", action="store_true",
                   help="recompute MBConv blocks, BiFPN cells and heads in the backward")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over every visible card (DDP)")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial partitioning: shard the image height this many ways "
                        "(a data x space mesh over the ranks)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism (FSDP2): parameter, gradient and "
                        "optimizer storage split 1/N over the cards")
    p.add_argument("--earlyStopPatience", type=int, default=10,
                   help="epochs without train-loss improvement before stopping (0 disables)")
    p.add_argument("--deviceAug", action="store_true",
                   help="blur/affine/noise augmentation batched on the device "
                        "(data/device_aug.py); the host only decodes and letterboxes")
    p.add_argument("--cacheDir", default=None,
                   help="staging cache directory (data/stage_cache.py; needs --deviceAug)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.cacheDir and not args.deviceAug:
        p.error("--cacheDir requires --deviceAug (only the fixed staging frame is "
                "deterministic; host augmentation draws anew every epoch)")
    check_parallel_flags(p, args)
    if args.batchSize % args.accumSteps:
        p.error("--accumSteps must divide --batchSize")
    return args


def main(argv=None):
    """Train; returns ``{"step", "epochs"}``, None where ``--dp``/``--fsdp``/``--sp``
    ran the ranks in processes of their own."""
    from tmv_tpu_torch.parallel.launch import run_ranks

    return run_ranks(train, parse_args(argv))


def train(args):
    """The trainer in this process (one rank of ``--dp``/``--fsdp``/``--sp``, or
    alone)."""
    from tmv_tpu_torch.parallel.launch import data_parallel

    with data_parallel(args) as par:
        return _train(args, par)


def _train(args, par):
    import torch

    from tmv_tpu_torch.core.callbacks import EarlyStopping, GracefulShutdown
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.core.metrics import MetricsLogger, StepTimer
    from tmv_tpu_torch.core.schedules import cosine_lr_schedule, scaled_lr
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline
    from tmv_tpu_torch.data.loaders import load_classes
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.models.efficientdet.config import get_efficientdet_config
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
    from tmv_tpu_torch.models.efficientdet.net import init_weights, make_efficientdet_loss_fn
    from tmv_tpu_torch.parallel.collectives import agree_any

    device = check_device(args.device) if par is None else par.device
    lead = par is None or par.rank == 0
    size = args.imageSize or get_efficientdet_config(args.modelName).image_size
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # head size follows the dataset: its classes + background id 0
    _, names_num = load_classes(args.classesFile)
    model, anchors = build_efficientdet(args.modelName, names_num + 1, size, dtype=dtype,
                                        device=device, param_dtype=torch.float32,
                                        remat=args.remat)
    cfg = model.config
    pipeline = EfficientDetPipeline(args.trainImagePath, args.trainData, args.classesFile,
                                    args.batchSize, anchors, cfg.num_classes, image_size=size,
                                    max_boxes=args.maxBoxes, device_aug=args.deviceAug,
                                    cache_dir=args.cacheDir, device=device,
                                    rows=None if par is None else rank_rows(args, par))
    init_weights(model, 0)
    model = model.to(memory_format=torch.channels_last)

    schedule = cosine_lr_schedule(scaled_lr(0.08, args.batchSize), 0.008, args.stepsPerEpoch,
                                  args.epochs * args.stepsPerEpoch)
    optimizer = torch.optim.SGD(model.parameters(), lr=float(schedule(0)), momentum=0.9)
    state = TrainState.create(model, optimizer, ema_decay=0.9998)
    mgr = CheckpointManager(args.modelPath)
    state = mgr.restore(state)
    if state.step and lead:
        print(f"resumed from step {state.step}", flush=True)

    generator = torch.Generator(device)
    loss_fn = make_efficientdet_loss_fn(generator=generator)
    step_fn = make_train_step(loss_fn, clip_global_norm=10.0, ema_decay=0.9998,
                              accum_steps=args.accumSteps, lr_schedule=schedule)
    if par is not None:
        state = par.put_state(state)
        step_fn = par.wrap_step(step_fn)
        print(f"{parallel_mode(args, par)} rank {par.rank} of {par.world} on {device}",
              flush=True)
    logger = MetricsLogger(os.path.join(args.modelPath, "metrics.jsonl") if lead else None,
                           print_every=20 if lead else 0)
    timer = StepTimer(batch_size=args.batchSize)
    early = EarlyStopping(patience=args.earlyStopPatience) if args.earlyStopPatience else None
    shutdown = GracefulShutdown()

    total = args.epochs * args.stepsPerEpoch
    epoch_losses, pending = [], []
    warned_fg = False

    def record():
        # a step's metrics are read after the next step is queued, so the host
        # does not wait for the card at every step
        for i, m in pending:
            logger.log(i, m)
            epoch_losses.append(float(m["loss"]))
        pending.clear()

    it = iter(pipeline)
    try:
        for step_i in range(state.step, total):
            batch = next(it)
            if not warned_fg and lead:
                warn_zero_foreground(batch, cfg)
                warned_fg = True
            generator.manual_seed(step_i)
            metrics = step_fn(state, batch if args.sp <= 1 else par.put_rows(batch))
            metrics.update(timer.tick())
            record()
            pending.append((step_i, metrics))
            stop = agree_any(shutdown.requested, None if par is None else par.data_group)
            if stop or (step_i + 1) % args.stepsPerEpoch == 0:
                record()
            if stop:
                print(f"preemption signal: checkpointing at step {state.step} and exiting",
                      flush=True)
                break
            if (step_i + 1) % args.stepsPerEpoch == 0:
                mgr.save(state.step, state, wait=False)
                epoch_loss = float(np.mean(epoch_losses))
                epoch_losses = []
                if early is not None and early.update(epoch_loss):
                    if lead:
                        print(f"early stopping: no improvement for {args.earlyStopPatience} "
                              "epochs", flush=True)
                    break
        record()
    finally:
        it.close()
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    logger.close()
    return {"step": state.step, "epochs": state.step // args.stepsPerEpoch} if lead else None


def warn_zero_foreground(batch, cfg):
    """Warn where the first batch assigns no anchor to any box: with no anchor at
    IoU ≥ 0.5 every target is background, the classifier learns to predict
    nothing and the mAP is exactly 0."""
    if sum(float(m.sum()) for m in batch["masks"]) == 0:
        print("WARNING: first batch assigned ZERO foreground anchors — the ground-truth "
              "boxes are likely far from every anchor size (anchor_scale "
              f"{cfg.anchor_scale}, levels {cfg.min_level}-{cfg.max_level} at "
              f"{cfg.image_size} px).  Training will converge to background-only output; "
              "adjust image size or the config's anchor_scale.", flush=True)


if __name__ == "__main__":
    main()
