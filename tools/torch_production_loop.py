"""The production loop through the PyTorch port's CLIs: train, eval, export, serve.

Port of ``tools/e2e_production_loop.py``. Every stage reads the previous stage's
files on disk:

  1. train  - ``tmv_tpu_torch.cli.train_yolo --version v3`` on the 8 synthetic
              coloured-box images of the JAX tool (its ``make_dataset``, seed 0) at
              64 px: 2,000 steps at b8, ``--lr 5e-4 --warmupSteps 0
              --earlyStopPatience 0``, as the JAX tool passes them;
  2. eval   - ``tmv_tpu_torch.cli.eval_map`` on the checkpoint, per batch with the
              reference integrator and global COCO;
  3. export - ``tmv_tpu_torch.cli.export_model --platforms cuda,cpu`` writes the
              baked artifact (the NMS kernel in it as the ``tmv::nms_sweep`` op);
  4. serve  - ``python -m tmv_tpu_torch.cli.serve --artifact`` in a process of its
              own, then one HTTP POST of a training image with ``read`` 1.

It writes ``e2e_production_loop_torch.json`` (``--out``) with the JAX file's keys,
the JAX package's figures beside them (``e2e_production_loop.json``) and the card's
name and power limit (``nvidia-smi``), and exits non-zero where the JAX tool's checks
fail (mAP per batch above 0.3, the reference's JSON keys, a served box, IoU of 0.25 or
more with the ground truth). It runs on the card:

    python3 tools/torch_production_loop.py [--out path.json] [--workDir dir]
"""

import argparse
import base64
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS_PER_EPOCH, EPOCHS = 100, 20
JAX_KEYS = ("mAP_ref_per_batch", "mAP_coco_global", "serve_best_iou_vs_gt")


def make_dataset(root, n=8, hw=96):
    """The JAX tool's set: ``n`` dark ``hw``² JPEGs, each with one red or green box."""
    import numpy as np
    from PIL import Image

    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        img = rng.integers(0, 60, (hw, hw, 3), dtype=np.uint8)
        x1 = int(rng.integers(4, hw - 40))
        y1 = int(rng.integers(4, hw - 40))
        w = int(rng.integers(24, 36))
        h = int(rng.integers(24, 36))
        cls = "red" if rng.uniform() < 0.5 else "green"
        img[y1:y1 + h, x1:x1 + w] = [220, 30, 30] if cls == "red" else [30, 220, 30]
        name = f"im{i}.jpg"
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=95)
        lines.append(f"{name}|{cls},{x1},{y1},{x1 + w},{y1 + h}|")
    with open(os.path.join(root, "labels.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("red\ngreen\n")
    with open(os.path.join(root, "anchors.txt"), "w") as f:
        f.write("6,6, 8,8, 10,10, 12,12, 16,16, 20,20, 24,24, 28,28, 32,32\n")


def iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_and_post(base, artifact, image_path, timeout=300):
    """``serve --artifact`` in its own process on a free port → the answer to one POST
    of ``image_path`` (``read`` 1); the server is stopped before returning."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tmv_tpu_torch.cli.serve", *base, "--artifact", artifact,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        deadline = time.time() + timeout
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"serve --artifact exited with {proc.returncode}")
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(1)
        with open(image_path, "rb") as f:
            body = json.dumps({"img_data": "data:image/jpeg;base64,"
                               + base64.b64encode(f.read()).decode(), "read": 1}).encode()
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/ai_api/object_detection/predict", body,
            {"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(request, timeout=120).read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "e2e_production_loop_torch.json"))
    p.add_argument("--workDir", default=None, help="default: a new temporary directory")
    args = p.parse_args(argv)

    from tmv_tpu_torch.cli import eval_map, export_model, train_yolo

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]
    result = {}
    t0 = time.time()
    root = args.workDir or tempfile.mkdtemp(prefix="tmv_torch_loop_")
    make_dataset(root)
    ckpt = os.path.join(root, "weights")
    base = ["--classesFile", os.path.join(root, "classes.txt"),
            "--anchorsFile", os.path.join(root, "anchors.txt"), "--imageSize", "64"]

    # 1. train: the JAX tool's overfit regime
    t = time.time()
    train_yolo.main(base + [
        "--version", "v3", "--trainData", os.path.join(root, "labels.txt"),
        "--trainImagePath", os.path.join(root, "imgs"), "--batchSize", "8",
        "--stepsPerEpoch", str(STEPS_PER_EPOCH), "--epochs", str(EPOCHS), "--lr", "5e-4",
        "--warmupSteps", "0", "--modelPath", ckpt, "--earlyStopPatience", "0"])
    result["train_steps"] = STEPS_PER_EPOCH * EPOCHS
    result["train_sec"] = round(time.time() - t, 1)

    # 2. the eval CLI on the checkpoint, both modes
    for mode, variant, key in (("batch", "reference", "mAP_ref_per_batch"),
                               ("global", "coco", "mAP_coco_global")):
        result[key] = eval_map.main(base + [
            "--family", "yolo", "--version", "v3", "--imagePath", os.path.join(root, "imgs"),
            "--labelFile", os.path.join(root, "labels.txt"), "--modelPath", ckpt,
            "--mode", mode, "--variant", variant, "--confidenceThresh", "0.2",
            "--scoresThresh", "0.05"])["mAP"]

    # 3. export the trained predictor
    artifact = os.path.join(root, "model.tmvt")
    t = time.time()
    export_model.main(base + ["--version", "v3", "--modelPath", ckpt, "--out", artifact,
                              "--platforms", "cuda,cpu", "--confidenceThresh", "0.2",
                              "--scoresThresh", "0.05"])
    result["export_sec"] = round(time.time() - t, 1)
    result["artifact_mb"] = round(os.path.getsize(artifact) / 1e6, 2)

    # 4. serve the artifact and POST a training image: the box must come back
    out = serve_and_post(base[:2] + base[4:], artifact, os.path.join(root, "imgs", "im0.jpg"))
    result["serve_contract_keys"] = sorted(out)
    result["serve_boxes"] = len(out["boxes"])
    with open(os.path.join(root, "labels.txt")) as f:
        gt = [float(v) for v in f.readline().strip().split("|")[1].split(",")[1:5]]
    result["serve_best_iou_vs_gt"] = round(max((iou(b, gt) for b in out["boxes"]),
                                               default=0.0), 4)
    result["wall_sec"] = round(time.time() - t0, 1)
    result["card"] = card
    with open(os.path.join(ROOT, "e2e_production_loop.json")) as f:
        jax_result = json.load(f)
    result["jax"] = {k: jax_result[k] for k in JAX_KEYS}

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    checks = [(result["mAP_ref_per_batch"] > 0.3, "the model failed to converge"),
              (result["serve_contract_keys"] == ["boxes", "classes", "random_img",
                                                 "result_img"], "the reference's JSON keys"),
              (result["serve_boxes"] >= 1, "no detection through the artifact"),
              (result["serve_best_iou_vs_gt"] >= 0.25,
               "the served detections miss the ground truth")]
    failed = [why for ok, why in checks if not ok]
    if failed:
        raise SystemExit(f"production loop failed: {'; '.join(failed)}")
    print("TORCH-PRODUCTION-LOOP-OK")


if __name__ == "__main__":
    main()
