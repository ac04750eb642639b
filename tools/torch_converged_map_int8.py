"""Score the converged YOLOv4 or YOLOv3 of the PyTorch port through its static int8 path.

The int8 passes of the JAX package's converged artifacts (written by
``tools/e2e_converged_map.py``): ``tmv_tpu_torch.cli.eval_map --mode global
--variant reference`` at confidence 0.2 and score 0.05 with ``--int8Static``
per-tensor and ``--int8PerChannel``, and for YOLOv4 each again at ``--int8Margin``
0.5 (``converged_map_v4.json``'s passes; ``converged_map.json`` has YOLOv3's
per-tensor one); the activation scales are calibrated on the set's first 16
images, as the JAX CLI calibrates them, and every ConvBN runs through the int8 conv
kernel (``tmv_tpu_torch/csrc/int8_conv.cu``; its launches are counted). The float
pass is scored beside them. It writes ``converged_map_v4_int8_torch.json``
(``converged_map_v3_int8_torch.json`` for ``--version v3``; or ``--out``) with the
card's name and power limit and the JAX artifact's numbers.

    python tools/torch_converged_map_int8.py --workDir dir [--version v4|v3] [--out path.json]

Each int8 pass is then re-scored with the plain versions patched in
(``rescore_int8``: ``int8_conv_reference``, and for EfficientDet
``int8_dwconv_reference``, in place of the kernels, float32 convolutions without
TF32): the kept rows must be identical and the four mAPs equal, on a checkpoint
that keeps boxes. It is written under each pass's ``plain_kernel_rescore``, and
the tool exits non-zero if one fails.

The checkpoint is ``tools/torch_converged_map.py``'s, in ``--workDir/weights_<version>``:
where there is none, that tool trains it first (4,000 steps, about 10 minutes on
an H100), writing its own result to ``--workDir/converged_map_<version>_torch.json``.
The eval runs on the card (``--device cuda``) in float32, as the model was trained.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
# (key of the JAX artifact, the eval CLI's int8 flags)
PASSES = {
    "v4": [("mAP_ref_global", []),
           ("mAP_ref_global_int8_static", ["--int8Static"]),
           ("mAP_ref_global_int8_static_pc", ["--int8Static", "--int8PerChannel"]),
           ("mAP_ref_global_int8_static_m05", ["--int8Static", "--int8Margin", "0.5"]),
           ("mAP_ref_global_int8_static_pc_m05", ["--int8Static", "--int8PerChannel",
                                                  "--int8Margin", "0.5"])],
    "v3": [("mAP_ref_global", []),
           ("mAP_ref_global_int8_static", ["--int8Static"]),
           ("mAP_ref_global_int8_static_pc", ["--int8Static", "--int8PerChannel"])],
}
OUT = {"v4": "converged_map_v4_int8_torch.json", "v3": "converged_map_v3_int8_torch.json"}


def rescore_int8(eval_argv, records, depthwise=False):
    """``torch_converged_map.rescore_with_plain_kernels`` of an int8 eval with the
    int8 kernels' plain versions patched in where the int8 sites call them (and, with
    ``depthwise``, the depthwise one) → (comparison, passed): rows identical."""
    from torch_converged_map import rescore_with_plain_kernels

    from tmv_tpu_torch.kernels.int8_conv import int8_conv_reference, int8_dwconv_reference

    plain = [("tmv_tpu_torch.quant.static.int8_conv", int8_conv_reference),
             ("tmv_tpu_torch.quant.dynamic.int8_conv", int8_conv_reference)]
    if depthwise:
        plain.append(("tmv_tpu_torch.quant.static.int8_dwconv", int8_dwconv_reference))
    with contextlib.redirect_stdout(io.StringIO()):
        return rescore_with_plain_kernels(eval_argv, records, {"plain_int8": plain})


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workDir", required=True,
                   help="tools/torch_converged_map.py's dataset and checkpoints")
    p.add_argument("--version", choices=sorted(PASSES), default="v4")
    p.add_argument("--out", default=None, help="result file (default: the version's at the root)")
    args = p.parse_args(argv)
    import torch_converged_map

    version = args.version
    out_path = args.out or os.path.join(ROOT, OUT[version])
    t0 = time.time()
    root = args.workDir
    ckpt = os.path.join(root, f"weights_{version}")
    if not os.path.isdir(ckpt):
        torch_converged_map.main(["--version", version, "--workDir", root, "--out",
                                  os.path.join(root, f"converged_map_{version}_torch.json")])
    os.environ.update(torch_converged_map.RECIPE)
    from e2e_converged_map import SIZE

    from tmv_tpu_torch.cli import eval_map
    from tmv_tpu_torch.kernels import int8_conv

    with open(os.path.join(ROOT, torch_converged_map.JAX_ARTIFACT[version])) as f:
        jax_result = json.load(f)
    common = ["--classesFile", os.path.join(root, "classes.txt"), "--anchorsFile",
              os.path.join(root, "anchors.txt"), "--imageSize", str(SIZE), "--family", "yolo",
              "--version", version, "--imagePath", os.path.join(root, "imgs"), "--labelFile",
              os.path.join(root, "labels.txt"), "--modelPath", ckpt, "--mode", "global",
              "--variant", "reference", "--confidenceThresh", "0.2", "--scoresThresh", "0.05",
              "--batchSize", "16", "--device", "cuda"]
    result = {"model": f"yolo_{version}", "image_size": SIZE, "dtype": "float32",
              "calibration_images": 16, "port": "tmv_tpu_torch", "card": card_name(),
              "checkpoint": "tools/torch_converged_map.py (4,000 steps)", "passes": {}}
    failed = []
    for key, extra in PASSES[version]:
        int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
        with contextlib.redirect_stdout(io.StringIO()):
            out = eval_map.main(common + extra)
        result[key] = out["mAP"]
        entry = result["passes"][key] = {
            "flags": extra, "images": out["images"], "quant": out["quant"],
            "int8_conv_launches": int8_conv.launches["int8_conv"], "jax": jax_result.get(key)}
        if extra and not int8_conv.launches["int8_conv"]:
            sys.exit(f"{key}: the int8 eval launched no int8_conv kernel")
        if extra:
            entry["plain_kernel_rescore"], ok = rescore_int8(common + extra,
                                                             eval_map.predict_records)
            if not ok:
                failed.append(key)
    result["jax_artifact"] = {key: jax_result.get(key) for key, _ in PASSES[version]}
    result["wall_sec"] = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    if failed:
        sys.exit(f"the re-score with the plain int8 kernels disagrees with the kernels' in "
                 f"{failed} (see plain_kernel_rescore)")


if __name__ == "__main__":
    main()
