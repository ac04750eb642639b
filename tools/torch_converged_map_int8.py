"""Score the converged YOLOv4 of the PyTorch port through its static int8 path.

The int8 passes of the JAX package's ``converged_map_v4.json`` (written by
``tools/e2e_converged_map.py`` with ``TMV_CMAP_VERSION=v4``): ``tmv_tpu_torch.cli.eval_map
--mode global --variant reference`` at confidence 0.2 and score 0.05 with
``--int8Static`` per-tensor and ``--int8PerChannel``, each at ``--int8Margin`` 1.0
and 0.5; the activation scales are calibrated on the set's first 16 images, as the
JAX CLI calibrates them, and every ConvBN runs through the int8 conv kernel
(``tmv_tpu_torch/csrc/int8_conv.cu``; its launches are counted). The float pass is
scored beside them. It writes ``converged_map_v4_int8_torch.json`` (or ``--out``)
with the card's name and power limit and the JAX artifact's numbers.

    python tools/torch_converged_map_int8.py --workDir dir [--out path.json]

The checkpoint is ``tools/torch_converged_map.py``'s, in ``--workDir/weights_v4``:
where there is none, that tool trains it first (4,000 steps, about 10 minutes on
an H100), writing its own result to ``--workDir/converged_map_v4_torch.json``. The
eval runs on the card (``--device cuda``) in float32, as the model was trained.
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
# (key of converged_map_v4.json, the eval CLI's int8 flags)
PASSES = [("mAP_ref_global", []),
          ("mAP_ref_global_int8_static", ["--int8Static"]),
          ("mAP_ref_global_int8_static_pc", ["--int8Static", "--int8PerChannel"]),
          ("mAP_ref_global_int8_static_m05", ["--int8Static", "--int8Margin", "0.5"]),
          ("mAP_ref_global_int8_static_pc_m05", ["--int8Static", "--int8PerChannel",
                                                 "--int8Margin", "0.5"])]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workDir", required=True,
                   help="tools/torch_converged_map.py's dataset and checkpoints")
    p.add_argument("--out", default=os.path.join(ROOT, "converged_map_v4_int8_torch.json"))
    args = p.parse_args(argv)
    import torch_converged_map

    t0 = time.time()
    root = args.workDir
    ckpt = os.path.join(root, "weights_v4")
    if not os.path.isdir(ckpt):
        torch_converged_map.main(["--workDir", root, "--out",
                                  os.path.join(root, "converged_map_v4_torch.json")])
    os.environ.update(torch_converged_map.RECIPE)
    from e2e_converged_map import SIZE

    from tmv_tpu_torch.cli import eval_map
    from tmv_tpu_torch.kernels import int8_conv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    with open(os.path.join(ROOT, "converged_map_v4.json")) as f:
        jax_result = json.load(f)
    common = ["--classesFile", os.path.join(root, "classes.txt"), "--anchorsFile",
              os.path.join(root, "anchors.txt"), "--imageSize", str(SIZE), "--family", "yolo",
              "--version", "v4", "--imagePath", os.path.join(root, "imgs"), "--labelFile",
              os.path.join(root, "labels.txt"), "--modelPath", ckpt, "--mode", "global",
              "--variant", "reference", "--confidenceThresh", "0.2", "--scoresThresh", "0.05",
              "--batchSize", "16", "--device", "cuda"]
    result = {"model": "yolo_v4", "image_size": SIZE, "dtype": "float32",
              "calibration_images": 16, "port": "tmv_tpu_torch", "card": card,
              "checkpoint": "tools/torch_converged_map.py (4,000 steps)", "passes": {}}
    for key, extra in PASSES:
        int8_conv.launches.update(int8_conv=0, int8_dwconv=0)
        with contextlib.redirect_stdout(io.StringIO()):
            out = eval_map.main(common + extra)
        result[key] = out["mAP"]
        result["passes"][key] = {"flags": extra, "images": out["images"],
                                 "quant": out["quant"],
                                 "int8_conv_launches": int8_conv.launches["int8_conv"],
                                 "jax": jax_result.get(key)}
        if extra and not int8_conv.launches["int8_conv"]:
            sys.exit(f"{key}: the int8 eval launched no int8_conv kernel")
    result["jax_artifact"] = {key: jax_result.get(key) for key, _ in PASSES}
    result["wall_sec"] = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
