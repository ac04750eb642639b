"""Train YOLOv4 or YOLOv3 to convergence through the PyTorch port's CLIs and score it.

The recipe of the JAX package's converged artifacts (written by
``tools/e2e_converged_map.py``): ``converged_map_v4.json`` (``TMV_CMAP_VERSION=v4``)
for ``--version v4``, ``converged_map.json`` (the tool's default version) for
``--version v3``. The synthetic set of ``make_dataset`` (seed 7; 256 images of 416 x
416 on disk, 4 colour classes, 1-6 boxes each, white distractors), anchors scaled to
the 416 input, the model at 416, batch 16, Adam at 5e-4 with no warm-up, 40 epochs of
100 steps (4,000 steps), no early stop, staged through the cache (``--cacheDir``, as
the JAX run; it changes no pixel); then ``tmv_tpu_torch.cli.eval_map`` at confidence
0.2 and score 0.05 in the four float passes of the JAX artifact. It writes
``mAP_ref_per_batch``, ``mAP_ref_global``, ``mAP_voc_global``, ``mAP_coco_global``,
the JAX artifact's ``mAP_ref_global`` and the gap to it, the wall time and the card's
name and power limit to ``converged_map_v4_torch.json`` (``converged_map_v3_torch.json``
for v3; or ``--out``).

    python tools/torch_converged_map.py [--version v4|v3] [--out path.json] [--workDir dir]

It runs on the card (``--device cuda``) in float32, as the JAX artifact was
trained; the int8 passes are ``tools/torch_converged_map_int8.py``'s. A
``--workDir`` that already holds the trained checkpoint is resumed at its last
step, so a second run only scores.

Then the re-score pass (``rescore_with_plain_kernels``): the converged
checkpoint's eval predictions are made again with the NMS kernel and with its
plain version ``greedy_sweep_reference`` patched in; the kept rows must be
identical and the four mAPs equal, on a checkpoint that keeps boxes. It is
written under ``plain_kernel_rescore``, and the tool exits non-zero if it fails.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the JAX artifact's recipe (tools/e2e_converged_map.py reads these at import)
RECIPE = {"TMV_CMAP_N": "256", "TMV_CMAP_SIZE": "416", "TMV_CMAP_HW": "416"}
EPOCHS, STEPS_PER_EPOCH, BATCH, LR = 40, 100, 16, "5e-4"
PASSES = [("batch", "reference", "mAP_ref_per_batch"), ("global", "reference", "mAP_ref_global"),
          ("global", "voc", "mAP_voc_global"), ("global", "coco", "mAP_coco_global")]
# the JAX artifact of each version's recipe, and the port's result file
JAX_ARTIFACT = {"v4": "converged_map_v4.json", "v3": "converged_map.json"}
OUT = {"v4": "converged_map_v4_torch.json", "v3": "converged_map_v3_torch.json"}
BOUND = 0.03   # PERF.md section 2: within 0.03 of the JAX package's mAP_ref_global


def rescore_with_plain_kernels(eval_argv, records, patches, tolerance=None):
    """The eval CLI's per-image records on ``eval_argv`` (``records(args) ->
    (records, classes_num)``) with the kernels, then with each set of plain
    versions of ``patches`` (``{name: [(target, plain), …]}``) patched in, all
    with float32 convolutions without TF32 (so that the kernels are the only
    difference). Returns the comparison and whether it passed: every run keeps
    boxes and scores the four mAPs equal to the kernels'; its kept rows are
    identical, or, for a run named in ``tolerance`` (``{name: (box, score)}``),
    of the same count and classes with boxes and scores within the bounds."""
    from unittest import mock

    import numpy as np
    import torch

    from tmv_tpu_torch.cli import eval_map

    args = eval_map.parse_args(eval_argv)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {"kernels": records(args)}
        for name, targets in patches.items():
            with contextlib.ExitStack() as stack:
                for target, plain in targets:
                    stack.enter_context(mock.patch(target, plain))
                runs[name] = records(args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    def maps(recs, classes_num):
        return {key: eval_map.score_dataset(recs, classes_num, mode, variant, 0.5)
                for mode, variant, key in PASSES}

    base, classes_num = runs.pop("kernels")
    kept = sum(len(r["prediction"]) for r in base)
    out = {"tf32_convolutions": False, "kept_boxes": kept, "kernels": maps(base, classes_num)}
    ok = kept > 0
    for name, (recs, _) in runs.items():
        same_shape, box, score = True, 0.0, 0.0
        for a, b in zip(base, recs):
            pa = np.asarray(a["prediction"], np.float64).reshape(-1, 6)
            pb = np.asarray(b["prediction"], np.float64).reshape(-1, 6)
            if pa.shape != pb.shape or not np.array_equal(pa[:, 4], pb[:, 4]):
                same_shape = False
            elif len(pa):
                box = max(box, float(np.abs(pa[:, :4] - pb[:, :4]).max()))
                score = max(score, float(np.abs(pa[:, 5] - pb[:, 5]).max()))
        identical = all(a["prediction"] == b["prediction"] for a, b in zip(base, recs))
        run = {"identical_rows": identical, "same_count_and_classes": same_shape,
               "max_box_diff": box, "max_score_diff": score, "mAPs": maps(recs, classes_num)}
        run["equal_mAPs"] = run["mAPs"] == out["kernels"]
        bounds = (tolerance or {}).get(name)
        rows_ok = identical or (bounds is not None and same_shape and box <= bounds[0]
                                and score <= bounds[1])
        ok = ok and rows_ok and run["equal_mAPs"]
        out[name] = run
    out["passed"] = ok
    return out, ok


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--version", choices=sorted(JAX_ARTIFACT), default="v4")
    p.add_argument("--out", default=None, help="result file (default: the version's at the root)")
    p.add_argument("--workDir", default=None, help="dataset and checkpoints (default: a temp dir)")
    args = p.parse_args(argv)
    version = args.version
    out_path = args.out or os.path.join(ROOT, OUT[version])
    os.environ.update(RECIPE)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from e2e_converged_map import HW, N_IMAGES, SIZE, make_dataset

    import torch

    from tmv_tpu_torch.cli import eval_map, train_yolo

    t0 = time.time()
    root = args.workDir or tempfile.mkdtemp(prefix="tmv_torch_converged_")
    make_dataset(root)
    ckpt = os.path.join(root, f"weights_{version}")
    cache = ["--cacheDir", os.path.join(root, "cache")]
    files = ["--classesFile", os.path.join(root, "classes.txt"),
             "--anchorsFile", os.path.join(root, "anchors.txt"), "--imageSize", str(SIZE)]
    train = train_yolo.main(files + cache + [
        "--version", version, "--trainData", os.path.join(root, "labels.txt"),
        "--trainImagePath", os.path.join(root, "imgs"), "--batchSize", str(BATCH),
        "--stepsPerEpoch", str(STEPS_PER_EPOCH), "--epochs", str(EPOCHS), "--lr", LR,
        "--warmupSteps", "0", "--modelPath", ckpt, "--earlyStopPatience", "0"])
    train_sec = time.time() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    result = {"n_images": N_IMAGES, "train_steps": train["step"], "image_size": SIZE,
              "image_hw_on_disk": HW, "lr": LR, "batch_size": BATCH, "model": f"yolo_{version}",
              "dtype": "float32",
              "tf32_convolutions": torch.backends.cudnn.allow_tf32, "port": "tmv_tpu_torch",
              "card": card}
    for mode, variant, key in PASSES:
        with contextlib.redirect_stdout(io.StringIO()):
            out = eval_map.main(files + cache + [
                "--family", "yolo", "--version", version, "--imagePath", os.path.join(root, "imgs"),
                "--labelFile", os.path.join(root, "labels.txt"), "--modelPath", ckpt,
                "--mode", mode, "--variant", variant, "--confidenceThresh", "0.2",
                "--scoresThresh", "0.05", "--batchSize", str(BATCH)])
        result[key] = out["mAP"]
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference

    with open(os.path.join(ROOT, JAX_ARTIFACT[version])) as f:
        jax_map = json.load(f)["mAP_ref_global"]
    result["jax_artifact"] = {"file": JAX_ARTIFACT[version], "mAP_ref_global": jax_map}
    result["gap_to_jax"] = result["mAP_ref_global"] - jax_map
    result["within_bound"] = bool(abs(result["gap_to_jax"]) <= BOUND)
    result["train_sec"] = train_sec
    eval_argv = files + ["--family", "yolo", "--version", version, "--imagePath",
                         os.path.join(root, "imgs"), "--labelFile",
                         os.path.join(root, "labels.txt"), "--modelPath", ckpt,
                         "--confidenceThresh", "0.2", "--scoresThresh", "0.05",
                         "--batchSize", str(BATCH)]
    with contextlib.redirect_stdout(io.StringIO()):
        result["plain_kernel_rescore"], rescored = rescore_with_plain_kernels(
            eval_argv, eval_map.predict_records,
            {"plain_sweep": [("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference)]})
    result["wall_sec"] = time.time() - t0
    result["converged"] = bool(result["mAP_ref_global"] > 0.5 and result["mAP_coco_global"] > 0.15)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    if not rescored:
        sys.exit("the re-score with the plain kernels disagrees with the kernels' (see "
                 "plain_kernel_rescore)")


if __name__ == "__main__":
    main()
