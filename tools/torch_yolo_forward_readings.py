"""Time the PyTorch port's YOLOv4 @640 float forward on the card, to compare two
checkouts of ``tmv_tpu_torch`` within one run.

    python tools/torch_yolo_forward_readings.py --roots PARENT_DIR . [--out f.json]

Each root is a directory that holds a ``tmv_tpu_torch`` package. The tool runs one
process per reading in the order a, b, b, a (so that drift of the card shows), and
each process imports the package from its own root, builds a YOLOv4 with 80
classes from seed 0 in bf16, ``channels_last``, eval mode, no quantization, and
times it after 3 warm-up forwards of each batch: the b1 forward
p50 over 30 forwards, each between two CUDA events, and b16 images/s over 10
back-to-back forwards between two events. It prints one JSON line per reading and
writes them all, with the card's name and power limit, to ``--out``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

IMAGE = 640


def reading(root):
    """One process's reading of the package under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import tmv_tpu_torch
    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.layers.common import init_weights

    package = os.path.dirname(os.path.abspath(tmv_tpu_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(root):
        raise SystemExit(f"tmv_tpu_torch came from {package}, not from {root}")
    model, _ = build_yolo_model("v4", 80, dtype=torch.bfloat16, device="cuda")
    init_weights(model, 0)
    model = model.to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(29)
    one = torch.from_numpy(rng.uniform(0, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    many = torch.from_numpy(rng.uniform(0, 1, (16, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        for _ in range(3):
            model(one), model(many)
        samples = []
        for _ in range(30):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model(one)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            model(many)
        end.record()
        torch.cuda.synchronize()
    return {"root": root, "b1_p50_ms": statistics.median(samples),
            "b16_images_per_s": 16 * 10 * 1000 / start.elapsed_time(end)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--roots", nargs=2, metavar=("A", "B"))
    p.add_argument("--out", default=None)
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(reading(args.one)), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    a, b = args.roots
    readings = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True, check=True)
        readings.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(dict(readings[-1], card=card)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "model": f"yolo_v4 @{IMAGE} bf16 float forward",
                       "readings": readings}, f, indent=1)


if __name__ == "__main__":
    main()
