#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tmv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, YOLOv4 @640 (80 classes, full width, seeded random
weights) served at ``POST /ai_api/object_detection/predict``, through the
hand-written greedy-NMS CUDA kernel. Phases, each printing its own lines:

1. environment: torch/CUDA/nvcc versions and the card (nvidia-smi);
2. build: the NMS sweep kernel from ``tmv_tpu_torch/csrc/nms_sweep.cu``;
3. the kernel against its plain version (``greedy_sweep_reference``) on the card:
   kept masks must be exactly equal over N in {1, 127, 128, 1000, 1024, 3000},
   B in {1, 16}, iou/diou, xyxy/yxyx, with and without class-aware, on clustered
   boxes with tied scores, ineligible padding and zero-area boxes; then both
   times at N = 1024, B = 1 and 16 (class-aware diou xyxy, CUDA events, turns
   plain, kernel, kernel, plain);
4. the slice in f32 with TF32 off: the batched predictor with the kernel and
   with the plain sweep give identical detections, and the card's heads agree
   with the CPU forward of the same state_dict (tolerance 1e-4·max|ref|);
5. serving: the port's server, built by ``tmv_tpu_torch.cli.serve.build_app``
   in bf16, answers seeded synthetic JPEGs on a free localhost port; every
   request must go through the kernel;
6. numbers: b1 image→boxes p50 and b16 images/sec of the bf16 predictor @640,
   the served requests' p50, and the predictor's stage times (H2D, forward,
   post-process, D2H, whole) at b1 and b16 in bf16 and in f32 with TF32 off.

The weights are ``--randomInit --seed 0`` (He-uniform, as the JAX package
initialises) with the three output convs' box rows scaled by 1e-4: unscaled,
the heads reach |z| ~ 1e4 at 640 and decode to no valid box, which would leave
the NMS sweep nothing to do. The card's name and power limit stand beside every
number. The last line is ``{"ok": true, "device": {...}}``; any failure raises
and exits non-zero, and without a CUDA device nothing is run.
"""

import base64
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
IMAGE = 640
KERNEL_SOURCE = "tmv_tpu_torch/csrc/nms_sweep.cu"
KERNEL_REPLACES = "tmv_tpu/kernels/nms_pallas.py:90"
PREDICT_KW = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="diou")
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat",
    "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball",
    "kite", "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket",
    "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush",
)


def check(ok, message):
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- inputs

def sweep_case(rng, n, batch, coord):
    """Score-sorted sweep inputs: clustered boxes (10% zero-area), scores on a
    1/8 grid (ties), the last 10% of each row ineligible padding, 3 classes."""
    centers = rng.uniform(10, 90, (batch, n // 4 + 1, 2))
    pick = rng.integers(0, n // 4 + 1, (batch, n))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 3, (batch, n, 2))
    wh = rng.uniform(5, 25, (batch, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    flat = rng.uniform(size=(batch, n)) < 0.1
    boxes[..., 2] = np.where(flat, boxes[..., 0], boxes[..., 2])
    scores = np.round(rng.uniform(0, 1, (batch, n)) * 8) / 8
    valid = rng.uniform(size=(batch, n)) > 0.1
    valid[:, n - n // 10:] = False
    order = np.argsort(-np.where(valid, scores, -np.inf), axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    if coord == "yxyx":
        boxes = boxes[..., [1, 0, 3, 2]]
    eligible = np.take_along_axis(valid & (scores >= 0.25), order, 1)
    classes = rng.integers(0, 3, (batch, n))
    return np.ascontiguousarray(boxes, np.float32), eligible, classes.astype(np.int32)


def scene_jpeg(rng, height, width):
    """A seeded synthetic photo: gradient, coloured rectangles, mild noise."""
    from PIL import Image

    y, x = np.mgrid[0:height, 0:width]
    img = np.stack([x * 255 // width, y * 255 // height, (x + y) * 127 // (width + height)], -1)
    for _ in range(6):
        h, w = rng.integers(height // 8, height // 2), rng.integers(width // 8, width // 2)
        top, left = rng.integers(0, height - h), rng.integers(0, width - w)
        img[top:top + h, left:left + w] = rng.integers(0, 256, 3)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


# ---------------------------------------------------------------- phases

def phase_environment():
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import nvcc_path

    nvcc = run([nvcc_path(), "--version"]).splitlines()[-1]
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(f"phase 1 environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc [{nvcc}], card [{card}], "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1 environment: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (f32 is compared in full f32)", flush=True)
    return card


def phase_build():
    from tmv_tpu_torch.kernels import nms_sweep

    t0 = time.perf_counter()
    nms_sweep.build()
    seconds = time.perf_counter() - t0
    regs = sorted({line.split("Used ")[1].split(" registers")[0]
                   for line in nms_sweep.build_log.splitlines() if "registers" in line})
    print(f"phase 2 build: {KERNEL_SOURCE} -> sm_90a in {seconds:.2f} s "
          f"(8 instantiations, registers per thread {','.join(regs) or 'cached build'})",
          flush=True)


def phase_kernel(card):
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep, greedy_sweep_reference

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases, max_err, kept_total = 0, 0, 0
    for n in (1, 127, 128, 1000, 1024, 3000):
        for batch in (1, 16):
            for coord in ("xyxy", "yxyx"):
                boxes, eligible, classes = (torch.from_numpy(a).to(dev)
                                            for a in sweep_case(rng, n, batch, coord))
                for iou_type in ("iou", "diou"):
                    for cls in (None, classes):
                        got = greedy_sweep(boxes, eligible, cls, 0.5, iou_type, coord)
                        want = greedy_sweep_reference(boxes, eligible, cls, 0.5, iou_type, coord)
                        torch.cuda.synchronize()
                        err = int((got.int() - want.int()).abs().max())
                        check(err == 0, f"kernel != plain at N={n} B={batch} {coord} "
                                        f"{iou_type} class_aware={cls is not None}")
                        max_err = max(max_err, err)
                        kept_total += int(got.sum())
                        cases += 1
    print(f"phase 3 kernel vs plain: {cases} cases, kept masks exactly equal "
          f"(max |kernel - plain| = {max_err}, {kept_total} boxes kept in all)", flush=True)

    times = {}
    for batch in (1, 16):
        boxes, eligible, classes = (torch.from_numpy(a).to(dev)
                                    for a in sweep_case(rng, 1024, batch, "xyxy"))

        def kernel():
            greedy_sweep(boxes, eligible, classes, 0.5, "diou", "xyxy")

        def plain():
            greedy_sweep_reference(boxes, eligible, classes, 0.5, "diou", "xyxy")

        kernel(), plain()
        turns = [cuda_ms(plain, 3), cuda_ms(kernel, 200), cuda_ms(kernel, 200), cuda_ms(plain, 3)]
        times[batch] = ((turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2)
        print(f"phase 3 time N=1024 B={batch} class-aware diou xyxy on [{card}]: "
              f"kernel {times[batch][0]:.4f} ms, plain {times[batch][1]:.2f} ms "
              f"(turns plain/kernel/kernel/plain: "
              f"{', '.join(f'{t:.4f}' for t in turns)} ms)", flush=True)
    return max_err, times


def seeded_model(dtype, device):
    """``--randomInit --seed 0`` weights with the output convs' box rows scaled."""
    import torch

    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.layers.common import init_weights

    model, iou_type = build_yolo_model("v4", 80, dtype=dtype)
    init_weights(model, 0)
    with torch.no_grad():
        for head in (model.DarknetConv_0, model.DarknetConv_1, model.DarknetConv_2):
            rows = torch.arange(head.Conv_0.out_channels) % 85 < 4
            head.Conv_0.weight[rows] *= 1e-4
    return model.to(device=device, memory_format=torch.channels_last).eval(), iou_type


def phase_slice(card):
    import torch

    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep_reference
    from tmv_tpu_torch.models.detector_harness import make_yolo_predict_batched
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS, YoloV4

    torch.backends.cudnn.deterministic = True
    model, iou_type = seeded_model(torch.float32, "cuda")
    check(iou_type == "diou", "YOLOv4 predicts with DIoU NMS")
    os.makedirs(WORK, exist_ok=True)
    weights = os.path.join(WORK, "yolov4_seed0.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)

    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (4, IMAGE, IMAGE, 3)).astype(np.float32)
    predict = make_yolo_predict_batched(model, (IMAGE, IMAGE), COCO_ANCHORS, 80, **PREDICT_KW)
    got = predict(None, images)
    with mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", greedy_sweep_reference):
        want = predict(None, images)
    for g, w, name in zip(got, want, ("boxes", "ids", "scores", "valid")):
        check(np.array_equal(g, w), f"slice {name} differ between kernel and plain sweep")
    boxes, ids, scores, valid = got
    check(boxes.shape == (4, 500, 4) and valid.shape == (4, 500), "predictor output shapes")
    check(valid.sum() > 0, "the slice kept no box")
    check(np.isfinite(boxes[valid]).all() and np.isfinite(scores[valid]).all(),
          "non-finite detections")
    check(((ids[valid] >= 0) & (ids[valid] < 80)).all(), "class ids out of range")
    print(f"phase 4 slice: YOLOv4 80 classes @{IMAGE} f32 B=4, kernel and plain sweep give "
          f"identical detections, kept per image {valid.sum(1).tolist()}", flush=True)

    with torch.inference_mode():
        card_heads = [h.float().cpu().numpy() for h in model(torch.from_numpy(images[:1]).cuda())]
        cpu_model = YoloV4(80).eval()
        cpu_model.load_state_dict(torch.load(weights, weights_only=True), strict=True)
        cpu_heads = [h.numpy() for h in cpu_model(torch.from_numpy(images[:1]))]
    rel = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(card_heads, cpu_heads))
    check(rel <= 1e-4, f"card heads differ from the CPU forward: {rel:.3g} of max|ref|")
    print(f"phase 4 slice: card heads vs CPU forward of the same state_dict: "
          f"max |diff| = {rel:.3g}·max|ref| (tolerance 1e-4) on [{card}]", flush=True)
    torch.backends.cudnn.deterministic = False
    return model, weights


def phase_serving(card, weights):
    import torch
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from tmv_tpu_torch.cli import serve
    from tmv_tpu_torch.kernels import nms_sweep
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    classes_file = os.path.join(WORK, "coco_classes.txt")
    with open(classes_file, "w") as f:
        f.write("\n".join(COCO_CLASSES) + "\n")
    anchors_file = os.path.join(WORK, "coco_anchors.txt")
    with open(anchors_file, "w") as f:
        f.write(",".join(str(int(v)) for v in COCO_ANCHORS[::-1].reshape(-1)))
    args = serve.parse_args(["--modelPath", weights, "--classesFile", classes_file,
                             "--anchorsFile", anchors_file, "--imageSize", str(IMAGE),
                             "--bf16", "--device", "cuda"])
    app, _, model = serve.build_app(args)
    check(all(p.device.type == "cuda" for p in model.parameters()), "model is not on cuda")

    class Quiet(WSGIRequestHandler):
        def log_message(self, *a):
            pass

    server = make_server("127.0.0.1", 0, app, handler_class=Quiet)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/ai_api/object_detection/predict"
    rng = np.random.default_rng(2)
    sizes = [(480, 640), (720, 1280), (640, 640), (375, 500), (1080, 1920)]
    latencies, by_read, boxes_seen = [], {0: [], 1: []}, 0
    try:
        nms_sweep.launches = 0
        for i in range(20):
            h, w = sizes[i % len(sizes)]
            read = 1 if i % 2 == 0 else 0
            data = "data:image/jpeg;base64," + base64.b64encode(scene_jpeg(rng, h, w)).decode()
            body = json.dumps({"img_data": data, "read": read}).encode()
            request = urllib.request.Request(url, body, {"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(request, timeout=60) as resp:
                    status, out = resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                raise RuntimeError(f"chip_smoke: request {i}: HTTP {e.code} "
                                   f"{e.read()[:2000]!r}") from e
            latencies.append((time.perf_counter() - t0) * 1000)
            by_read[read].append(latencies[-1])
            check(status == 200, f"request {i}: HTTP {status}")
            check(set(out) == {"boxes", "classes", "random_img", "result_img"},
                  f"request {i}: keys {sorted(out)}")
            check(len(out["boxes"]) == len(out["classes"]), f"request {i}: boxes/classes")
            check(bool(out["result_img"]) == bool(read), f"request {i}: read={read} images")
            boxes_seen += len(out["boxes"])
        launches = nms_sweep.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    check(launches >= len(latencies), f"{launches} kernel launches for {len(latencies)} requests")
    p50 = statistics.median(latencies)
    print(f"phase 5 serving: {len(latencies)} requests (read=1 and read=0, 375x500..1080x1920 "
          f"JPEGs) -> HTTP 200 with the reference keys, {boxes_seen} boxes; "
          f"nms_sweep.launches {launches}; served p50 {p50:.2f} ms "
          f"(read=0 {statistics.median(by_read[0]):.2f} ms, boxes only; "
          f"read=1 {statistics.median(by_read[1]):.2f} ms, with the two JPEGs drawn and "
          f"encoded) (YOLOv4 bf16 @{IMAGE}, on [{card}])", flush=True)
    return model, launches, p50


def stage_times(model, batch, reps=20):
    """Milliseconds per stage of the batched predictor @640 on ``batch`` seeded
    images: H2D (pageable, as the predictor copies) and D2H of the four outputs
    on the host clock around a synchronised copy; forward and post-process
    (decode, pre-NMS top-k, NMS, gathers) by CUDA events over ``reps``
    back-to-back calls; the whole predictor on the host clock. Medians of
    ``reps`` where the host clock is used."""
    import torch

    from tmv_tpu_torch.models.detector_harness import make_yolo_predict_batched
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.ops.yolo import nms_boxes_batched

    images = np.random.default_rng(4).uniform(0, 1, (batch, IMAGE, IMAGE, 3)).astype(np.float32)
    predict = make_yolo_predict_batched(model, (IMAGE, IMAGE), COCO_ANCHORS, 80, **PREDICT_KW)

    def host_ms(fn):
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1000)
        return statistics.median(samples)

    def post(heads):
        return nms_boxes_batched(heads, COCO_ANCHORS, (IMAGE, IMAGE), 80, **PREDICT_KW)

    for _ in range(3):
        predict(None, images)
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        heads = model(x)
        out = post(heads)
        return {"H2D": host_ms(lambda: torch.from_numpy(images).to("cuda")),
                "forward": cuda_ms(lambda: model(x), reps),
                "post-process": cuda_ms(lambda: post(heads), reps),
                "D2H": host_ms(lambda: [out[i].cpu() for i in (0, 1, 2, 5)]),
                "whole": host_ms(lambda: predict(None, images))}


def phase_numbers(card, model, model_f32, served_p50):
    import torch

    from tmv_tpu_torch.models.detector_harness import (
        make_yolo_predict, make_yolo_predict_batched,
    )
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS

    rng = np.random.default_rng(3)
    one = rng.uniform(0, 1, (1, IMAGE, IMAGE, 3)).astype(np.float32)
    sixteen = rng.uniform(0, 1, (16, IMAGE, IMAGE, 3)).astype(np.float32)
    predict = make_yolo_predict(model, (IMAGE, IMAGE), COCO_ANCHORS, 80, **PREDICT_KW)
    batched = make_yolo_predict_batched(model, (IMAGE, IMAGE), COCO_ANCHORS, 80, **PREDICT_KW)
    for _ in range(5):
        predict(None, one)
    latencies = []
    for _ in range(50):
        t0 = time.perf_counter()
        predict(None, one)                      # ends in a device-to-host copy
        latencies.append((time.perf_counter() - t0) * 1000)
    for _ in range(3):
        batched(None, sixteen)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        batched(None, sixteen)
    ips = 16 * reps / (time.perf_counter() - t0)
    b1 = statistics.median(latencies)
    print(f"phase 6 numbers on [{card}]: YOLOv4 80 classes bf16 @{IMAGE}: "
          f"b1 image->boxes p50 {b1:.2f} ms (host numpy in, host numpy out, 50 runs); "
          f"b16 batched predictor {ips:.1f} images/s; served p50 {served_p50:.2f} ms", flush=True)
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off for the f32 stage times")
    for name, m in (("bf16", model), ("f32, TF32 off", model_f32)):
        for batch in (1, 16):
            stages = stage_times(m, batch)
            print(f"phase 6 stages on [{card}]: YOLOv4 80 classes {name} @{IMAGE} b{batch}: "
                  + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()), flush=True)
    return b1, ips


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    max_err, times = phase_kernel(card)
    model_f32, weights = phase_slice(card)
    model, launches, served_p50 = phase_serving(card, weights)
    phase_numbers(card, model, model_f32, served_p50)
    print(json.dumps({"kernels": [{
        "name": "nms_sweep", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": round(times[1][0], 5), "plain_ms": round(times[1][1], 3)}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
