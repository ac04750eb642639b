"""Teacher→student distillation CLI on one GPU.

Port of ``tmv_tpu/cli/train_distill.py`` (the reference's
`unsupervised_learning/` scripts), with the JAX CLI's flags and defaults; the
network of every mode is ``ResNetYoloV3`` with ``--outFilters`` (default
``3·(5 + classes)``) output filters:

- ``--mode train_teacher``: supervised training on ``--trainData`` (the YOLO
  loss with IoU, Adam at ``--lr``, the shadow loss) into ``--teacherPath``;
- ``--mode promote``: the latest ``--studentPath`` weights become the teacher,
  saved at step 0 in ``--teacherPath`` with a fresh Adam state;
- ``--mode dump_labels``: the teacher labels every image under
  ``--trainImagePath`` in batches of ``--batchSize`` (``models/distill.py``:
  one batched forward and one class-aware IoU sweep per batch, a confidence
  threshold drawn per image in [0.3, 0.5)) and writes ``--labelsOut`` lines
  ``name|cls,x1,y1,x2,y2|…|`` with boxes to one decimal;
- ``--mode train_students``: each step draws ``--batchSize`` images
  (``np.random.default_rng(--seed)``), labels them with the teacher, builds the
  YOLO targets on the device (``data/yolo_targets.py``, batched) and takes a
  shadow-loss Adam step of the student in ``--studentPath``.

The teacher is read with ``core/checkpoint.py::load_weights`` (a checkpoint
directory or a ``.pt``). The thresholds come from one ``torch.Generator`` on the
device seeded by ``--seed`` plus the restored step, where JAX draws from
``jax.random.key`` of the batch's start (dump) or the step (students). The
images are decoded, resized proportionally to ``--imageSize`` and scaled to
[0, 1] on the host. ``--remat`` recomputes the towers' stages in the backward.
``--device cuda`` (the default) raises where there is no GPU; ``--device cpu``
is for tests.

Usage:
    python -m tmv_tpu_torch.cli.train_distill --mode train_teacher \\
        --trainImagePath ./imgs --trainData ./labels.txt --classesFile ./classes.txt \\
        --anchorsFile ./anchors.txt
    python -m tmv_tpu_torch.cli.train_distill --mode train_students \\
        --trainImagePath ./unlabelled --classesFile ./classes.txt --anchorsFile ./anchors.txt
"""

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", required=True,
                   choices=["train_teacher", "promote", "dump_labels", "train_students"])
    p.add_argument("--trainImagePath")
    p.add_argument("--trainData")
    p.add_argument("--classesFile")
    p.add_argument("--anchorsFile")
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--imageSize", type=int, default=416)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--teacherPath", default="./data/teacher_weights")
    p.add_argument("--studentPath", default="./data/student_weights")
    p.add_argument("--labelsOut", default="./data/teacher_labels.txt")
    p.add_argument("--outFilters", type=int, default=None)
    p.add_argument("--remat", action="store_true",
                   help="recompute each stage in the backward (torch.utils.checkpoint)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def staged_images(paths, image_wh) -> np.ndarray:
    """``(N, H, W, 3)`` float32 in [0, 1]: each file decoded, resized
    proportionally onto ``image_wh`` and divided by 255."""
    from tmv_tpu_torch.utils import image_helper

    out = []
    for path in paths:
        with open(path, "rb") as f:
            img = image_helper.bytes_to_image(f.read())
        img, _, _ = image_helper.proportional_resize(img, image_wh)
        out.append(img.astype(np.float32) / 255.0)
    return np.stack(out)


def train_loop(state, step_fn, next_batch, steps: int, mgr, print_every: int,
               save_every: int = 0):
    """Steps from ``state.step`` to ``steps`` with GracefulShutdown, the loss
    printed every ``print_every`` steps, an asynchronous save every
    ``save_every`` (0: none) and a final save; returns the raw losses."""
    from tmv_tpu_torch.core.callbacks import GracefulShutdown

    shutdown = GracefulShutdown()
    losses = []
    try:
        for i in range(state.step, steps):
            if shutdown.requested:
                print(f"preemption signal: checkpointing at step {state.step} and exiting",
                      flush=True)
                break
            metrics = step_fn(state, next_batch(i))
            losses.append(metrics["raw_loss"])
            if i % print_every == 0:
                print(f"step {i} loss {float(metrics['loss']):.4f}", flush=True)
            if save_every and (i + 1) % save_every == 0:
                mgr.save(state.step, state, wait=False)
    finally:
        shutdown.uninstall()
    mgr.save(state.step, state)
    mgr.close()
    return [float(v) for v in losses]


def main(argv=None):
    """Run ``--mode``; returns its summary: ``{"step", "losses"}`` for the two
    trainers, ``{"path"}`` for promote, ``{"path", "lines", "boxes"}`` for the
    dump."""
    import torch

    from tmv_tpu_torch.core.checkpoint import CheckpointManager, load_weights
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.loaders import load_anchors, load_classes
    from tmv_tpu_torch.data.yolo_targets import make_yolo_targets
    from tmv_tpu_torch.models.detector_harness import check_device, make_yolo_loss_fn
    from tmv_tpu_torch.models.distill import make_pseudo_label_fn, promote_teacher
    from tmv_tpu_torch.models.layers.common import init_weights
    from tmv_tpu_torch.models.moco import ResNetYoloV3
    from tmv_tpu_torch.utils.file_helper import read_file_list

    args = parse_args(argv)
    device = check_device(args.device)
    anchors = load_anchors(args.anchorsFile) if args.anchorsFile else None
    classes_name, classes_num = (load_classes(args.classesFile) if args.classesFile
                                 else ([], 0))
    image_wh = (args.imageSize, args.imageSize)
    out_filters = args.outFilters or 3 * (5 + classes_num)

    def tower():
        model = ResNetYoloV3(out_filters, device=device, remat=args.remat)
        init_weights(model, args.seed)
        return model.to(memory_format=torch.channels_last)

    def adam(model):
        return torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    def student_state(path):
        model = tower()
        mgr = CheckpointManager(path)
        return mgr.restore(TrainState.create(model, adam(model))), mgr

    if args.mode == "promote":
        student, mgr = student_state(args.studentPath)
        mgr.close()
        teacher = promote_teacher(student.model, tower())
        out = CheckpointManager(args.teacherPath)
        out.save(0, TrainState.create(teacher, adam(teacher)))
        out.close()
        print(f"promoted student → teacher at {args.teacherPath}", flush=True)
        return {"path": args.teacherPath}

    loss_fn = make_yolo_loss_fn(image_wh, anchors)
    if args.mode == "train_teacher":
        from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline

        pipeline = YoloDataPipeline(args.trainImagePath, args.trainData, args.classesFile,
                                    args.batchSize, anchors, image_wh=image_wh, device=device)
        state, mgr = student_state(args.teacherPath)
        it = iter(pipeline)
        try:
            losses = train_loop(state, make_train_step(loss_fn, shadow_loss=True),
                                lambda _: next(it), args.steps, mgr, print_every=100)
        finally:
            it.close()
        return {"step": state.step, "losses": losses}

    # the teacher's inference modes
    teacher = tower()
    load_weights(teacher, args.teacherPath)
    labeler = make_pseudo_label_fn(teacher, anchors, image_wh, classes_num)
    files = read_file_list(args.trainImagePath, r"\.(jpg|jpeg|png)$")

    def on_device(paths):
        return torch.from_numpy(staged_images(paths, image_wh)).to(device)

    if args.mode == "dump_labels":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        lines = boxes_written = 0
        with open(args.labelsOut, "w", encoding="utf-8") as f:
            for start in range(0, len(files), args.batchSize):
                chunk = files[start:start + args.batchSize]
                boxes, ids, valid = (t.cpu().numpy()
                                     for t in labeler(on_device(chunk), generator=gen))
                for pi, path in enumerate(chunk):
                    parts = [os.path.basename(path)]
                    for b, c in zip(boxes[pi][valid[pi]], ids[pi][valid[pi]]):
                        parts.append(f"{classes_name[int(c)]},{b[0]:.1f},{b[1]:.1f},"
                                     f"{b[2]:.1f},{b[3]:.1f}")
                    f.write("|".join(parts) + "|\n")
                    lines += 1
                    boxes_written += len(parts) - 1
        print(f"wrote {args.labelsOut}", flush=True)
        return {"path": args.labelsOut, "lines": lines, "boxes": boxes_written}

    # train_students: on-the-fly pseudo-labels feed the YOLO loss
    student, mgr = student_state(args.studentPath)
    gen = torch.Generator(device=device).manual_seed(args.seed + student.step)
    rng = np.random.default_rng(args.seed)

    def next_batch(_):
        chunk = [files[rng.integers(0, len(files))] for _ in range(args.batchSize)]
        images = on_device(chunk)
        boxes, ids, valid = labeler(images, generator=gen)
        targets = make_yolo_targets(boxes, ids, valid, anchors, image_wh, classes_num)
        return {"image": images, "targets": targets}

    losses = train_loop(student, make_train_step(loss_fn, shadow_loss=True), next_batch,
                        args.steps, mgr, print_every=100, save_every=1000)
    return {"step": student.step, "losses": losses}


if __name__ == "__main__":
    main()
