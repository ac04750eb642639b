"""FaceNet triplet training CLI on one GPU.

Port of ``tmv_tpu/cli/train_facenet.py`` (the reference's `facenet/train.py:64-128`
and the fit loop of `facenet_model.py:338-425`). Per outer step: sample
``--peoplePerBatch`` people × ``--imagesPerPerson`` images
(``models/facenet/dataset.py``), load them (PIL, proportional resize to
``--imageSize``, /255), embed them in eval mode (``get_embeddings``), mine
semi-hard triplets on the padded (people, images) grid (``select_triplets``, on
the card), keep the valid ones, shuffle them with ``np.random.default_rng(outer)``
(``outer`` counts this run's train steps, as in the JAX CLI, so equal triplets
come in JAX's order) and take one train step per ``--batchSize // 3`` triplets:
the triplet loss of a train-mode forward over anchors, positives and negatives,
the shadow loss and a weight EMA of ``--emaDecay`` over the parameters (the JAX
CLI leaves the BatchNorm statistics out of its EMA, and so does this one). Each
epoch ends with an asynchronous checkpoint and, given ``--lfwDir`` and
``--lfwPairs``, the LFW evaluation of the live weights. A run restored from
``--modelPath`` continues the step count and runs ``--epochs`` more epochs, as the
JAX CLI does.

``--optimizer`` follows optax's update rules (``make_optimizer``): ADAM and
ADADELTA are torch's, RMSPROP (eps 1.0 inside the square root, momentum 0.9)
and ADAGRAD (accumulator from 0.1) are ``core/train_state.py``'s. ``--remat``
recomputes each Inception block (each RepVGG block) in the backward. The people
draws, the mining noise and the dropout masks come from ``--seed`` plus the
restored step (the dataset's ``random.Random``, one ``torch.Generator`` on the
device). GracefulShutdown checkpoints after the outer step in which SIGTERM or
SIGINT arrived. ``--device cuda`` (the default) raises where there is no GPU;
``--device cpu`` is for tests.

Usage:
    python -m tmv_tpu_torch.cli.train_facenet --filesPath ./faces \\
        --lfwDir ./lfw --lfwPairs ./pairs.txt --modelPath ./data/facenet_weights
"""

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--filesPath", required=True, help="root dir: one subdir per person")
    p.add_argument("--backbone", default="InceptionResNetV1",
                   choices=["InceptionResNetV1", "InceptionResNetV2", "InceptionV4", "RepVGG"])
    p.add_argument("--embeddingSize", type=int, default=512)
    p.add_argument("--imageSize", type=int, default=160)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--batchSize", type=int, default=30)
    p.add_argument("--peoplePerBatch", type=int, default=45)
    p.add_argument("--imagesPerPerson", type=int, default=40)
    p.add_argument("--optimizer", default="ADAM",
                   choices=["ADAGRAD", "ADADELTA", "ADAM", "RMSPROP"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--stepsPerEpoch", type=int, default=100)
    p.add_argument("--modelPath", default="./data/facenet_weights")
    p.add_argument("--lfwDir", default=None)
    p.add_argument("--lfwPairs", default=None)
    p.add_argument("--emaDecay", type=float, default=0.9999)
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward (torch.utils.checkpoint)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_optimizer(name: str, lr: float, params):
    """The JAX CLI's optax optimizers, by optax's update rules."""
    import torch

    from tmv_tpu_torch.core.train_state import OptaxAdagrad, OptaxRMSprop

    return {
        "ADAGRAD": lambda: OptaxAdagrad(params, lr),
        "ADADELTA": lambda: torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6),
        "ADAM": lambda: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
        "RMSPROP": lambda: OptaxRMSprop(params, lr, decay=0.9, eps=1.0, momentum=0.9),
    }[name]()


def load_images(paths, image_size: int) -> np.ndarray:
    """``(N, image_size, image_size, 3)`` float32 in [0, 1]: each image resized
    proportionally and padded to the square."""
    from tmv_tpu_torch.data.image_ops import load_image
    from tmv_tpu_torch.utils.image_helper import proportional_resize

    out = []
    for p in paths:
        img, _, _ = proportional_resize(load_image(p), (image_size, image_size))
        out.append(img.astype(np.float32) / 255.0)
    return np.stack(out)


def mining_grid(emb: np.ndarray, num_per_class):
    """The padded ``(people, images, D)`` grid of ``emb``, its valid mask and the
    row of ``emb`` behind each grid cell."""
    p_num, i_num = len(num_per_class), max(num_per_class)
    grid = np.zeros((p_num, i_num, emb.shape[1]), np.float32)
    valid = np.zeros((p_num, i_num), bool)
    path_grid = np.zeros((p_num, i_num), np.int64)
    cursor = 0
    for pi, n in enumerate(num_per_class):
        grid[pi, :n] = emb[cursor:cursor + n]
        valid[pi, :n] = True
        path_grid[pi, :n] = np.arange(cursor, cursor + n)
        cursor += n
    return grid, valid, path_grid.reshape(-1)


def evaluate_lfw(model, lfw_dir: str, lfw_pairs: str, image_size: int, batch_size: int,
                 **kwargs):
    """``lfw.evaluate``'s (tpr, fpr, accuracy per fold, val, val_std, far) of
    ``model``'s embeddings of an LFW pair list; ``kwargs`` go to ``evaluate``."""
    from tmv_tpu_torch.models.facenet import get_embeddings, lfw

    paths, issame = lfw.get_paths(lfw_dir, lfw.read_pairs(lfw_pairs))
    emb = get_embeddings(model, load_images(paths, image_size), batch_size)
    return lfw.evaluate(emb, issame, **kwargs)


def main(argv=None):
    """Train; returns ``{"step", "losses", "outer", "lfw"}``: the raw loss of
    every step run, per outer step the host seconds of its load, embed, mine and
    steps parts with its triplet and step counts, and per epoch the LFW
    (accuracy per fold, val, val_std, far) where asked for."""
    import torch

    from tmv_tpu_torch.core.callbacks import GracefulShutdown
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.models.facenet import (
        FaceNetModel, get_embeddings, make_triplet_train_step, select_triplets,
    )
    from tmv_tpu_torch.models.facenet.dataset import FaceDataset
    from tmv_tpu_torch.models.facenet.model import init_weights

    args = parse_args(argv)
    device = check_device(args.device)
    model = FaceNetModel(args.embeddingSize, args.backbone, device=device, remat=args.remat)
    model = init_weights(model, args.seed).to(memory_format=torch.channels_last)
    state = TrainState.create(model, make_optimizer(args.optimizer, args.lr, model.parameters()),
                              ema_decay=args.emaDecay)
    mgr = CheckpointManager(args.modelPath)
    state = mgr.restore(state)
    if state.step:
        print(f"resumed from step {state.step}", flush=True)

    dataset = FaceDataset(args.filesPath, args.peoplePerBatch, args.imagesPerPerson,
                          seed=args.seed + state.step)
    generator = torch.Generator(device=device).manual_seed(args.seed + state.step)
    step_fn = make_train_step(make_triplet_train_step(args.alpha, generator), shadow_loss=True,
                              ema_decay=args.emaDecay)
    per_triplet_batch = args.batchSize // 3
    outer = 0
    losses, outer_log, lfw_log = [], [], []
    shutdown = GracefulShutdown()
    try:
        for epoch in range(args.epochs):
            for _ in range(args.stepsPerEpoch):
                t0 = time.perf_counter()
                paths, num_per_class = dataset.sample_people()
                images = load_images(paths, args.imageSize)
                t1 = time.perf_counter()
                emb = get_embeddings(model, images, args.batchSize)
                t2 = time.perf_counter()
                grid, valid, flat_idx = mining_grid(emb, num_per_class)
                triplets, tvalid = select_triplets(
                    torch.from_numpy(grid).to(device), torch.from_numpy(valid).to(device),
                    args.alpha, generator=generator)
                triplets = triplets[tvalid].cpu().numpy()
                t3 = time.perf_counter()
                np.random.default_rng(outer).shuffle(triplets)
                steps = 0
                for start in range(0, len(triplets) - per_triplet_batch + 1, per_triplet_batch):
                    chunk = flat_idx[triplets[start:start + per_triplet_batch]]
                    batch = {key: torch.from_numpy(images[chunk[:, j]]).to(device)
                             for j, key in enumerate(("anchor", "positive", "negative"))}
                    metrics = step_fn(state, batch)
                    losses.append(metrics["raw_loss"])
                    outer += 1
                    steps += 1
                if steps:
                    print(f"epoch {epoch} outer {outer} loss {float(metrics['loss']):.4f} "
                          f"triplets {len(triplets)}", flush=True)
                outer_log.append({"load": t1 - t0, "embed": t2 - t1, "mine": t3 - t2,
                                  "steps": time.perf_counter() - t3,
                                  "triplets": len(triplets), "train_steps": steps})
                if shutdown.requested:
                    break
            mgr.save(state.step, state, wait=False)
            if shutdown.requested:
                print(f"preemption signal: checkpointing at step {state.step} and exiting",
                      flush=True)
                break
            if args.lfwDir and args.lfwPairs:
                _, _, accuracy, val, val_std, far = evaluate_lfw(
                    model, args.lfwDir, args.lfwPairs, args.imageSize, args.batchSize)
                lfw_log.append((accuracy, val, val_std, far))
                print(f"LFW accuracy {accuracy.mean():.4f}±{accuracy.std():.4f} "
                      f"VAL {val:.4f}±{val_std:.4f} @ FAR={far:.4f}", flush=True)
    finally:
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    return {"step": state.step, "losses": [float(v) for v in losses], "outer": outer_log,
            "lfw": lfw_log}


if __name__ == "__main__":
    main()
