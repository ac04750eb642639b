"""YOLOv4 / YOLOv3 training CLI on one GPU.

Port of ``tmv_tpu/cli/train_yolo.py`` on one device: the train and val
pipelines, Adam at ``--lr`` with the shadow loss, ``--accumSteps``,
checkpoint resume with the epoch derived from the step, a per-epoch asynchronous
save, ReduceLROnPlateau, EarlyStopping, GracefulShutdown, the per-epoch val mAP
over ``min(50, labels)`` images through the predictor (and so through the NMS
kernel on the card), and a final save. v4's ``iou_type`` is ``ciou`` in the
loss and ``diou`` in the predictor; v3's is ``iou`` in both.

``--darknetWeights`` (a Darknet ``.weights`` stream, ``convert/darknet.py``)
starts from imported weights with the two-phase warm start of the reference
(`yolo_v3/train.py:79-87`): for ``--warmupSteps`` steps only the three output
convs ``DarknetConv_0/1/2`` train (``freeze_mask``/``masked_optimizer``, Adam
with the shadow loss, the BatchNorm statistics updating in train mode), then the
main phase starts at step 0 from the warmed weights and statistics with a fresh
Adam state. A resumed run (a checkpoint in ``--modelPath``) skips the warm-up.
``--mosaic p`` replaces each training image by a 4-image mosaic with
probability p (``data/mosaic.py``); ``--cacheDir`` keeps the decoded staging
frames of the train set in a memmap cache that later epochs read
(``data/stage_cache.py``); ``--remat`` recomputes each stage in the backward
instead of storing its activations (``layers.common.remat_call``).
``--bf16`` trains bf16 activations on float32 master
weights and float32 Adam moments. ``--device cuda`` (the default) raises where
there is no GPU; ``--device cpu`` is for tests.

``--dp`` trains data-parallel (``parallel.train.DataParallel``, DDP), ``--fsdp``
fully sharded (``parallel.fsdp.FullyShardedDataParallel``, FSDP2) and ``--sp N`` with
the image height split over N ranks (``parallel.spatial.SpatialDataParallel``, a
``(data, space)`` mesh of R / N x N ranks with hand-written halo exchanges), with the
JAX CLI's rules: ``--batchSize`` is the global batch (each rank decodes and trains its
data rows of it; under ``--sp`` each takes its rows of the image height), ``--dp`` is
implied by ``--fsdp`` and ``--sp``, and ``--fsdp`` does not combine with
``--sp``/``--tp``. Under ``torchrun`` the ranks join its group; run plainly, one rank
per visible card (``parallel.launch``; ``--sp N`` on fewer than N cards: N ranks sharing
them). Rank 0 alone logs, validates and writes (under ``--fsdp`` every rank runs the val
forwards, which gather the shards; the val forwards are not height-sharded). The
Darknet warm start does not run data-parallel (refused with ``--darknetWeights``).

Usage:
    python -m tmv_tpu_torch.cli.train_yolo --version v4 \\
        --trainData ./data/train_labels.txt --trainImagePath ./imgs \\
        --valData ./data/val_labels.txt --valImagePath ./imgs \\
        --classesFile ./data/classes.txt --anchorsFile ./data/anchors.txt --bf16

Checkpoints are ``<modelPath>/<step>.pt`` (``core/checkpoint.py``), with
``metrics.jsonl`` beside them; ``cli/eval_map.py`` scores them.
"""

import argparse
import os

import numpy as np

# The flag of the JAX CLI the port does not run yet → the later ROADMAP.md item.
_NOT_PORTED = {
    "--tp": (lambda a: a.tp > 1, "ROADMAP.md queue 6: multi-GPU training"),
}


def check_parallel_flags(p, args):
    """The JAX CLIs' rules for ``--dp``/``--sp``/``--tp``/``--fsdp``, then the refusal
    of the axis not ported yet (``--tp``) and of an image height ``--sp`` does not
    divide."""
    if args.sp > 1 and args.tp > 1:
        p.error("--sp and --tp cannot be combined on the CLI (use the parallel/ API "
                "directly for 3-D meshes)")
    if args.fsdp and (args.sp > 1 or args.tp > 1):
        p.error("--fsdp shards state over the data axis; it cannot be combined with "
                "--sp/--tp on the CLI")
    if args.dp and (args.sp > 1 or args.tp > 1 or args.fsdp):
        p.error("--dp is implied by --sp/--tp/--fsdp (their meshes already shard the batch "
                "over the data axis) — pass only one mode")
    refused = [f"{flag} ({where})" for flag, (given, where) in _NOT_PORTED.items()
               if given(args)]
    if refused:
        p.error(f"not yet ported to tmv_tpu_torch: {'; '.join(refused)}")
    # the port splits the input image's rows evenly (JAX leaves an image whose height
    # the space axis does not divide unsplit)
    if args.sp > 1 and args.imageSize and args.imageSize % args.sp:
        p.error(f"--imageSize {args.imageSize} is not divisible by --sp {args.sp}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--version", default="v4", choices=["v3", "v4"])
    p.add_argument("--trainData", required=True)
    p.add_argument("--trainImagePath", required=True)
    p.add_argument("--valData", default=None)
    p.add_argument("--valImagePath", default=None)
    p.add_argument("--classesFile", required=True)
    p.add_argument("--anchorsFile", required=True)
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--stepsPerEpoch", type=int, default=5000)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--modelPath", default="./data/yolo_weights")
    p.add_argument("--darknetWeights", default=None,
                   help="optional .weights warm start (convert.py parity)")
    p.add_argument("--warmupSteps", type=int, default=1000,
                   help="head-only warm start steps after --darknetWeights")
    p.add_argument("--mosaic", type=float, default=0.0,
                   help="per-image probability of the 4-image mosaic (data/mosaic.py)")
    p.add_argument("--cacheDir", default=None,
                   help="staging cache directory (data/stage_cache.py)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over every visible card (DDP)")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial partitioning: shard the image height this many ways "
                        "(a data x space mesh over the ranks)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism (FSDP2): parameter, gradient and "
                        "optimizer storage split 1/N over the cards")
    p.add_argument("--accumSteps", type=int, default=1,
                   help="gradient accumulation micro-steps (batchSize must divide)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each stage in the backward (torch.utils.checkpoint)")
    p.add_argument("--earlyStopPatience", type=int, default=10,
                   help="epochs without train-loss improvement before stopping (0 disables)")
    p.add_argument("--reduceLrFactor", type=float, default=0.1)
    p.add_argument("--reduceLrPatience", type=int, default=3,
                   help="flat epochs before LR *= factor (0 disables)")
    p.add_argument("--minLr", type=float, default=1e-6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    check_parallel_flags(p, args)
    if args.batchSize % args.accumSteps:
        p.error("--accumSteps must divide --batchSize")
    if args.darknetWeights and (args.dp or args.fsdp or args.sp > 1):
        p.error("--darknetWeights (the head-only warm start) does not run under "
                "--dp/--fsdp/--sp; warm-start on one card, then resume from its checkpoint "
                "with --dp")
    return args


def main(argv=None):
    """Train; returns ``{"step", "epochs", "val_mAP"}`` (the per-epoch val mAPs), None
    where ``--dp``/``--fsdp``/``--sp`` ran the ranks in processes of their own."""
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

    from tmv_tpu_torch.core.callbacks import (
        EarlyStopping, GracefulShutdown, ReduceLROnPlateau, set_learning_rate,
    )
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.core.metrics import MetricsLogger, StepTimer
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.loaders import load_anchors
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.models.detector_harness import (
        build_yolo_model, check_device, make_yolo_loss_fn, make_yolo_predict,
    )
    from tmv_tpu_torch.models.layers.common import init_weights
    from tmv_tpu_torch.parallel.collectives import agree_any

    device = check_device(args.device) if par is None else par.device
    lead = par is None or par.rank == 0
    rows = None if par is None else rank_rows(args, par)
    anchors = load_anchors(args.anchorsFile)
    image_wh = (args.imageSize, args.imageSize)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    pipeline = YoloDataPipeline(args.trainImagePath, args.trainData, args.classesFile,
                                args.batchSize, anchors, image_wh=image_wh, mosaic=args.mosaic,
                                cache_dir=args.cacheDir, device=device, rows=rows)
    model, predict_iou_type = build_yolo_model(args.version, pipeline.classes_num,
                                               anchors.shape[1], dtype=dtype, device=device,
                                               param_dtype=torch.float32, remat=args.remat)
    init_weights(model, 0)
    if args.darknetWeights:
        from tmv_tpu_torch.convert.darknet import load_darknet_weights

        load_darknet_weights(model, args.darknetWeights, input_size=(image_wh[1], image_wh[0]))
        print(f"loaded darknet weights: {args.darknetWeights}", flush=True)
    model = model.to(memory_format=torch.channels_last)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    state = TrainState.create(model, optimizer)
    mgr = CheckpointManager(args.modelPath)
    state = mgr.restore(state)
    start_step = state.step
    if start_step and lead:
        print(f"resumed from step {start_step}", flush=True)

    loss_fn = make_yolo_loss_fn(image_wh, anchors,
                                iou_type="ciou" if args.version == "v4" else "iou")
    if args.darknetWeights and start_step == 0 and args.warmupSteps:
        warm_start(model, loss_fn, pipeline, args.lr, args.warmupSteps)
    step_fn = make_train_step(loss_fn, shadow_loss=True, accum_steps=args.accumSteps)
    if par is not None:
        state = par.put_state(state)
        step_fn = par.wrap_step(step_fn)
        print(f"{parallel_mode(args, par)} rank {par.rank} of {par.world} on {device}",
              flush=True)
    optimizer = state.optimizer
    logger = MetricsLogger(os.path.join(args.modelPath, "metrics.jsonl") if lead else None,
                           print_every=50 if lead else 0)
    timer = StepTimer(batch_size=args.batchSize)
    predict_fn = make_yolo_predict(model, image_wh, anchors, pipeline.classes_num,
                                   iou_type=predict_iou_type)
    shutdown = GracefulShutdown()
    early = EarlyStopping(patience=args.earlyStopPatience) if args.earlyStopPatience else None
    plateau = (ReduceLROnPlateau(factor=args.reduceLrFactor, patience=args.reduceLrPatience,
                                 min_lr=args.minLr, base_lr=args.lr)
               if args.reduceLrPatience else None)

    total_steps = args.stepsPerEpoch * args.epochs
    epoch_losses, val_maps, pending = [], [], []

    def record():
        # a step's metrics are read after the next step is queued, so the host
        # does not wait for the card at every step
        for i, m in pending:
            logger.log(i, m)
            epoch_losses.append(float(m["loss"]))
        pending.clear()

    it = iter(pipeline)
    try:
        for step_i in range(start_step, total_steps):
            batch = next(it)
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
                if plateau is not None:
                    new_lr = plateau.update(epoch_loss)
                    set_learning_rate(optimizer, new_lr)
                    if lead:
                        print(f"epoch loss {epoch_loss:.4f} lr {new_lr:.2e}", flush=True)
                if early is not None and early.update(epoch_loss):
                    if lead:
                        print(f"early stopping: no improvement for {args.earlyStopPatience} "
                              "epochs", flush=True)
                    break
                # an FSDP-sharded forward is a collective: every rank runs the val pass
                if args.valData and (lead or args.fsdp):
                    val_maps.append(validate(args, anchors, image_wh, device, model,
                                             predict_fn, pipeline.classes_num))
                    if lead:
                        print(f"epoch {(step_i + 1) // args.stepsPerEpoch} "
                              f"val_mAP={val_maps[-1]:.4f}", flush=True)
        record()
    finally:
        it.close()
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    logger.close()
    if not lead:
        return None
    return {"step": state.step, "epochs": state.step // args.stepsPerEpoch, "val_mAP": val_maps}


def rank_rows(args, par):
    """This rank's rows of the global ``--batchSize`` batch (``--accumSteps``
    micro-batches each split over the data ranks); exits where they do not divide."""
    from tmv_tpu_torch.parallel.mesh import shard_rows

    rank, world = getattr(par, "data_rank", par.rank), getattr(par, "data_world", par.world)
    try:
        return shard_rows(args.batchSize, rank, world, args.accumSteps)
    except ValueError as e:
        raise SystemExit(f"--batchSize {args.batchSize}: {e}")


def parallel_mode(args, par) -> str:
    """How the ranks split the step, for the start-up line."""
    if args.sp > 1:
        return (f"spatial (data {par.data_world} x space {args.sp}, data rank "
                f"{par.data_rank})")
    return "fsdp (ZeRO-3)" if args.fsdp else "data-parallel"


HEAD_PREFIXES = ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2")


def warm_start(model, loss_fn, pipeline, lr: float, steps: int):
    """The head-only warm-up (FreeLayer parity, `yolo_v3/train.py:79-87`):
    ``steps`` steps of Adam at ``lr`` with the shadow loss on a state of its own
    over the output convs only; the module keeps the warmed parameters and
    BatchNorm statistics, and every parameter trains again afterwards."""
    import torch

    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.detector_harness import freeze_mask, frozen, masked_optimizer

    mask = freeze_mask(model, HEAD_PREFIXES)
    warm = TrainState.create(model, masked_optimizer(
        lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
        model, mask))
    warm_step = make_train_step(loss_fn, shadow_loss=True)
    it = iter(pipeline)
    try:
        with frozen(model, mask):
            for _ in range(steps):
                warm_step(warm, next(it))
    finally:
        it.close()
    print("warm start done", flush=True)


def validate(args, anchors, image_wh, device, model, predict_fn, classes_num):
    """Mean per-image mAP over the first ``min(50, labels)`` val images, the
    model in eval mode (running statistics) meanwhile."""
    from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
    from tmv_tpu_torch.models.detector_harness import eval_map_step

    val = YoloDataPipeline(args.valImagePath, args.valData, args.classesFile, 1, anchors,
                           image_wh=image_wh, image_random=False, label_mean=False,
                           device=device)
    model.eval()
    vit = iter(val)
    try:
        maps = [eval_map_step(predict_fn, None, next(vit), classes_num)
                for _ in range(min(50, val.labels_num))]
    finally:
        vit.close()
        model.train()
    return float(np.mean(maps))


if __name__ == "__main__":
    main()
