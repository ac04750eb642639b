"""Train EfficientDet-D0 to convergence through the PyTorch port's CLIs and score it.

The recipe of the JAX package's ``converged_map_ed.json`` (written by
``tools/e2e_converged_map_ed.py``): the synthetic set of ``make_dataset`` (seed 7;
256 images of 512 x 512 on disk, 4 colour classes, 1-6 boxes each, white
distractors), EfficientDet-D0 at 512 with the dataset's 4 classes + background,
batch 16, SGD with momentum 0.9 on the cosine schedule (peak 0.08 · 16 / 64,
one epoch of warmup), 40 epochs of 100 steps (4,000 steps), ``--deviceAug``,
float32, no early stop; then ``tmv_tpu_torch.cli.eval_map --family
efficientdet`` in the four float passes of the JAX artifact and its int8 pass
(``--mode global --variant reference --int8Static``: per-tensor activation
scales calibrated on the set's first 16 images, every backbone, BiFPN and head
conv through the int8 kernels, ``int8_conv`` and ``int8_dwconv``, their launches
counted). It writes ``mAP_ref_per_batch``, ``mAP_ref_global``,
``mAP_voc_global``, ``mAP_coco_global``, ``mAP_ref_global_int8_static`` beside the
JAX artifact's, the times and the card's name and power limit to
``converged_map_ed_torch.json`` (or ``--out``).

    python tools/torch_converged_map_ed.py [--out path.json] [--workDir dir]

It runs on the card (``--device cuda``). The JAX run staged through its cache
(``--cacheDir``), which changes no pixel; the port's EfficientDet pipelines stage
every batch. A ``--workDir`` that already holds the trained checkpoint is resumed
at its last step, so a second run only scores.

Then the re-score pass (``torch_converged_map.rescore_with_plain_kernels``,
float32 convolutions without TF32): the converged checkpoint's eval predictions
again with the NMS kernel's plain version ``greedy_sweep_reference`` patched in
(kept rows identical, the four mAPs equal), and with it and the depthwise
kernel's plain version ``dw_bn_swish_reference`` (kept rows of the same count
and classes, boxes within 1e-3 px and scores within 1e-5, the four mAPs equal),
on a checkpoint that keeps boxes. It is written under ``plain_kernel_rescore``;
the int8 pass is re-scored in the same way with both int8 kernels' plain
versions patched in (``torch_converged_map_int8.rescore_int8``: kept rows
identical), under ``int8_static.plain_kernel_rescore``. The tool exits non-zero
if either fails.
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
RECIPE = {"TMV_CMAP_N": "256", "TMV_CMAP_SIZE": "512", "TMV_CMAP_HW": "512"}
EPOCHS, STEPS_PER_EPOCH, BATCH = 40, 100, 16
PASSES = [("batch", "reference", "mAP_ref_per_batch"), ("global", "reference", "mAP_ref_global"),
          ("global", "voc", "mAP_voc_global"), ("global", "coco", "mAP_coco_global")]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "converged_map_ed_torch.json"))
    p.add_argument("--workDir", default=None, help="dataset and checkpoints (default: a temp dir)")
    args = p.parse_args(argv)
    os.environ.update(RECIPE)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from e2e_converged_map import HW, N_IMAGES, SIZE, make_dataset

    import torch

    from tmv_tpu_torch.cli import eval_map, train_efficientdet

    t0 = time.time()
    root = args.workDir or tempfile.mkdtemp(prefix="tmv_torch_converged_ed_")
    make_dataset(root)
    ckpt = os.path.join(root, "weights_d0")
    files = ["--modelName", "efficientdet-d0", "--classesFile", os.path.join(root, "classes.txt"),
             "--imageSize", str(SIZE)]
    train = train_efficientdet.main(files + [
        "--trainData", os.path.join(root, "labels.txt"),
        "--trainImagePath", os.path.join(root, "imgs"), "--batchSize", str(BATCH),
        "--stepsPerEpoch", str(STEPS_PER_EPOCH), "--epochs", str(EPOCHS), "--deviceAug",
        "--modelPath", ckpt, "--earlyStopPatience", "0"])
    train_sec = time.time() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    result = {"n_images": N_IMAGES, "train_steps": train["step"], "image_size": SIZE,
              "image_hw_on_disk": HW, "device_aug": True, "batch_size": BATCH,
              "model": "efficientdet-d0", "dtype": "float32",
              "tf32_convolutions": torch.backends.cudnn.allow_tf32, "port": "tmv_tpu_torch",
              "card": card}
    for mode, variant, key in PASSES:
        with contextlib.redirect_stdout(io.StringIO()):
            out = eval_map.main(files + [
                "--family", "efficientdet", "--imagePath", os.path.join(root, "imgs"),
                "--labelFile", os.path.join(root, "labels.txt"), "--modelPath", ckpt,
                "--mode", mode, "--variant", variant, "--batchSize", str(BATCH)])
        result[key] = out["mAP"]
    from torch_converged_map import rescore_with_plain_kernels

    from tmv_tpu_torch.kernels.dwconv import dw_bn_swish_reference
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference

    result["train_sec"] = train_sec
    eval_argv = files + ["--family", "efficientdet", "--imagePath", os.path.join(root, "imgs"),
                         "--labelFile", os.path.join(root, "labels.txt"), "--modelPath", ckpt,
                         "--batchSize", str(BATCH)]
    sweep = ("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference)
    depthwise = ("tmv_tpu_torch.models.efficientdet.backbone.fused_dw_bn_swish",
                 dw_bn_swish_reference)
    with contextlib.redirect_stdout(io.StringIO()):
        result["plain_kernel_rescore"], rescored = rescore_with_plain_kernels(
            eval_argv, eval_map.efficientdet_records,
            {"plain_sweep": [sweep], "plain_sweep_and_depthwise": [sweep, depthwise]},
            tolerance={"plain_sweep_and_depthwise": (1e-3, 1e-5)})
    # the JAX artifact's int8 pass, through both int8 kernels, then re-scored with
    # their plain versions
    from torch_converged_map_int8 import rescore_int8

    from tmv_tpu_torch.kernels import int8_conv

    int8_argv = eval_argv + ["--mode", "global", "--variant", "reference", "--int8Static"]
    int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
    with contextlib.redirect_stdout(io.StringIO()):
        out = eval_map.main(int8_argv)
    with open(os.path.join(ROOT, "converged_map_ed.json")) as f:
        jax_int8 = json.load(f)["mAP_ref_global_int8_static"]
    result["mAP_ref_global_int8_static"] = out["mAP"]
    result["int8_static"] = {"quant": out["quant"], "images": out["images"],
                             "int8_conv_launches": int8_conv.launches["int8_conv"],
                             "int8_dwconv_launches": int8_conv.launches["int8_dwconv"],
                             "jax": jax_int8}
    result["int8_static"]["plain_kernel_rescore"], rescored_int8 = rescore_int8(
        int8_argv, eval_map.efficientdet_records, depthwise=True)
    result["wall_sec"] = time.time() - t0
    result["converged"] = bool(result["mAP_ref_global"] > 0.5)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    if not rescored or not rescored_int8:
        sys.exit("the re-score with the plain kernels disagrees with the kernels' (see "
                 "plain_kernel_rescore)")
    if not out["quant"] == "int8_static" or not result["int8_static"]["int8_dwconv_launches"]:
        sys.exit(f"the int8 pass did not run through the int8 kernels: {result['int8_static']}")


if __name__ == "__main__":
    main()
