"""Train the converged YOLO recipe several times on one card and report the spread.

Runs ``tools/torch_converged_map.py --version V`` ``--runs`` times, as concurrent
processes on the same card (each with its own work directory and result file,
``<workDir>/run<i>/`` and ``<workDir>/run<i>.json``), then writes the runs'
``mAP_ref_global`` (and the other three float mAPs), their median, minimum,
maximum and spread, the JAX artifact's ``mAP_ref_global``, the median's gap to it
and whether it lies within the 0.03 bound of ``PERF.md`` section 2, with the
card's name and power limit, to ``--out``.

    python tools/torch_converged_map_runs.py --runs 3 --workDir dir --out runs.json

The recipe is the tool's own (4,000 steps at b16, float32, no warm-up); running
the processes side by side changes what each step waits for on the host, not what
it computes. A run that fails fails the tool, after the others have finished.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
KEYS = ("mAP_ref_global", "mAP_ref_per_batch", "mAP_voc_global", "mAP_coco_global")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--version", choices=("v4", "v3"), default="v4")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--workDir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch_converged_map
    from torch_converged_map_int8 import card_name

    t0 = time.time()
    os.makedirs(args.workDir, exist_ok=True)
    outs = [os.path.join(args.workDir, f"run{i}.json") for i in range(args.runs)]
    procs = []
    for i, out in enumerate(outs):
        log = open(os.path.join(args.workDir, f"run{i}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools", "torch_converged_map.py"),
             "--version", args.version, "--workDir", os.path.join(args.workDir, f"run{i}"),
             "--out", out], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    codes = []
    for proc, log in procs:
        codes.append(proc.wait())
        log.close()
    if any(codes):
        sys.exit(f"runs exited {codes}; see {args.workDir}/run*.log")
    runs = []
    for out in outs:
        with open(out) as f:
            runs.append(json.load(f))
    with open(os.path.join(ROOT, torch_converged_map.JAX_ARTIFACT[args.version])) as f:
        jax_map = json.load(f)["mAP_ref_global"]
    values = [r["mAP_ref_global"] for r in runs]
    median = statistics.median(values)
    result = {"model": f"yolo_{args.version}", "runs": args.runs, "concurrent": True,
              "card": card_name(), "port": "tmv_tpu_torch",
              "recipe": {k: runs[0][k] for k in ("n_images", "train_steps", "image_size",
                                                 "lr", "batch_size", "dtype")},
              "per_run": [{k: r[k] for k in KEYS + ("train_sec",)} for r in runs],
              "mAP_ref_global_median": median, "mAP_ref_global_min": min(values),
              "mAP_ref_global_max": max(values), "spread": max(values) - min(values),
              "jax_mAP_ref_global": jax_map, "median_gap_to_jax": median - jax_map,
              "median_within_bound": bool(abs(median - jax_map) <= torch_converged_map.BOUND),
              "plain_kernel_rescore_passed": all(r["plain_kernel_rescore"]["passed"]
                                                 for r in runs),
              "wall_sec": time.time() - t0}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
