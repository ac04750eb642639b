"""Seeded inputs shared by the PyTorch port's tests (``test_torch_*.py``).

Everything is made with numpy from a seed and handed to both the JAX function
and its port as numpy arrays. jax is imported only where a helper needs it, so
that the CUDA cases can run on a GPU host without the JAX package's
dependencies.
"""

import shutil

import numpy as np
import pytest


def cluster_boxes(rng, n, coord="xyxy"):
    """Overlapping boxes around n/4 centres (as ``tests/test_nms_pallas.py``)."""
    centers = rng.uniform(10, 90, size=(n // 4 + 1, 2))
    idx = rng.integers(0, len(centers), size=n)
    c = centers[idx] + rng.normal(0, 3, size=(n, 2))
    wh = rng.uniform(5, 25, size=(n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1).astype(np.float32)
    return boxes[:, [1, 0, 3, 2]] if coord == "yxyx" else boxes


def nms_case(rng, n, classes_num=3, zero_area=True, tied=True):
    """Boxes, scores (rounded so that ties occur), classes and a padding mask."""
    boxes = cluster_boxes(rng, n)
    if zero_area:
        flat = rng.uniform(size=n) < 0.1
        boxes[flat, 2] = boxes[flat, 0]
    scores = rng.uniform(0, 1, size=n).astype(np.float32)
    if tied:
        scores = np.round(scores * 8) / 8
    classes = rng.integers(0, classes_num, size=n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    return boxes, scores.astype(np.float32), classes, valid


def seeded_variables(shapes, rng):
    """Fill a flax ``eval_shape`` tree: He-uniform kernels, and non-trivial BN
    scale/bias/mean/var so that the BatchNorm mapping is really exercised."""
    import jax

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, s.shape).astype(np.float32)
        limit = np.sqrt(6.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-limit, limit, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_leaf_count(tree):
    import jax

    return len(jax.tree_util.tree_leaves(tree))


@pytest.fixture()
def disposable_tmp(tmp_path):
    """``tmp_path``, deleted when the test ends: a full-width YOLO writes
    ~250 MB per weights file and ~750 MB per checkpoint with Adam moments, and
    pytest keeps the temporary directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture()
def one_torch_thread():
    """Run the test's torch ops on one thread. Under the parallel test workers,
    torch's OpenMP threads oversubscribe the cores and spin at every barrier,
    which slows a whole-D0 float64 forward by orders of magnitude."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def answer_one_request(app, seed=0, size=(48, 80)):
    """POST one seeded JPEG to a WSGI ``app`` at the reference's predict route,
    in process; returns (HTTP status line, the JSON answer)."""
    import base64
    import io
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(buf, "JPEG")
    body = json.dumps({"img_data": "data:image/jpeg;base64,"
                       + base64.b64encode(buf.getvalue()).decode(), "read": 0}).encode()
    status = {}

    def start_response(s, headers):
        status["status"] = s

    environ = {"PATH_INFO": "/ai_api/object_detection/predict", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    out = b"".join(app(environ, start_response))
    return status["status"], json.loads(out)


def write_yolo_inputs(root, classes=3):
    """A classes file and the COCO anchors file → the serving CLI's arguments."""
    anchors = np.array([[[116, 90], [156, 198], [373, 326]], [[30, 61], [62, 45], [59, 119]],
                        [[10, 13], [16, 30], [33, 23]]])
    (root / "classes.txt").write_text("\n".join(f"class_{i}" for i in range(classes)) + "\n")
    (root / "anchors.txt").write_text(",".join(str(int(v)) for v in anchors[::-1].reshape(-1)))
    return ["--classesFile", str(root / "classes.txt"), "--anchorsFile",
            str(root / "anchors.txt")]


def yolo_targets_batch(rng, anchors, size=64, batch=2, classes=3):
    """Images and JAX-made YOLO targets (``tmv_tpu.data.yolo_targets``) from 6
    random boxes per image, as numpy arrays."""
    import jax.numpy as jnp

    from tmv_tpu.data.yolo_targets import make_yolo_targets

    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    targets = []
    for _ in range(batch):
        x1 = rng.uniform(0, size - 24, 6)
        y1 = rng.uniform(0, size - 24, 6)
        boxes = np.stack([x1, y1, x1 + rng.uniform(4, 24, 6), y1 + rng.uniform(4, 24, 6)], -1)
        out = make_yolo_targets(jnp.asarray(boxes, jnp.float32),
                                jnp.asarray(rng.integers(0, classes, 6), jnp.int32),
                                jnp.ones(6, bool), anchors, (size, size), classes)
        targets.append([np.asarray(t) for t in out])
    return images, [np.stack(t) for t in zip(*targets)]


def write_tiny_set(root, count=4, size=64, names=("red", "green", "blue")):
    """``count`` seeded PNGs with two labelled boxes each, a classes file and a
    64 px anchors file → the file paths by role."""
    from PIL import Image

    rng = np.random.default_rng(17)
    (root / "imgs").mkdir(exist_ok=True)
    lines = []
    for i in range(count):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.png")
        lines.append(f"im{i}.png|{names[i % 3]},5,5,30,30|{names[(i + 1) % 3]},20,10,60,50|")
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(names) + "\n")
    (root / "anchors.txt").write_text(
        "6,6, 8,8, 10,10, 12,12, 16,16, 20,20, 24,24, 28,28, 32,32\n")
    return {k: str(root / v) for k, v in (("images", "imgs"), ("labels", "labels.txt"),
                                          ("classes", "classes.txt"),
                                          ("anchors", "anchors.txt"))}


def write_labelme(root, count=5):
    """``count`` seeded PNGs of 72 × 96 px, each with a labelme JSON holding one
    4-corner quad shape (corners in a shuffled order); one extra JSON with two
    shapes, kept only with ``first_shape``."""
    import json

    from PIL import Image

    rng = np.random.default_rng(11)
    for i in range(count + 1):
        Image.fromarray(rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)).save(
            root / f"q{i}.png")
        x0, y0 = rng.uniform(20, 35), rng.uniform(15, 25)
        x1, y1 = rng.uniform(60, 75), rng.uniform(45, 55)
        quad = [[x0, y0], [x1, y0 + 2], [x1 - 3, y1], [x0 + 2, y1 - 1]]
        order = rng.permutation(4)
        shapes = [{"label": "doc", "points": [quad[j] for j in order]}]
        if i == count:
            shapes.append({"label": "doc", "points": quad})
        (root / f"q{i}.json").write_text(json.dumps({"imagePath": f"q{i}.png",
                                                     "shapes": shapes}))
