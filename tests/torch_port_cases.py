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


def write_face_set(root, people=4, images=3, size=96, seed=0):
    """``root/<person>/<person>_NNNN.jpg``: each person a seeded colour pattern,
    each image that pattern plus per-image noise; returns the person names."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = [f"person_{p}" for p in range(people)]
    for name in names:
        (root / name).mkdir(parents=True, exist_ok=True)
        pattern = rng.uniform(0, 255, (8, 8, 3))
        base = np.kron(pattern, np.ones((size // 8, size // 8, 1)))
        for i in range(images):
            img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(root / name / f"{name}_{i + 1:04d}.jpg", quality=90)
    return names


def write_pairs(path, names, images, count=20, seed=0):
    """An LFW ``pairs.txt`` over ``names`` × ``images``: a header line, then
    alternating same (``name i j``) and different (``a i b j``) pairs."""
    rng = np.random.default_rng(seed)
    lines = [f"1\t{count}"]
    for k in range(count):
        if k % 2 == 0:
            name = names[rng.integers(len(names))]
            i, j = rng.choice(np.arange(1, images + 1), 2, replace=False)
            lines.append(f"{name}\t{i}\t{j}")
        else:
            a, b = rng.choice(len(names), 2, replace=False)
            lines.append(f"{names[a]}\t{rng.integers(1, images + 1)}\t{names[b]}\t"
                         f"{rng.integers(1, images + 1)}")
    path.write_text("\n".join(lines) + "\n")
    return path


def by_torch_name(tree):
    """A flax params or batch_stats tree as float64 numpy arrays under the torch
    ``state_dict`` names: conv kernels HWIO → OIHW, Dense kernels transposed
    (``flax_to_state_dict`` rounds to float32)."""
    import jax

    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(k.key) for k in path]
        array = np.asarray(leaf, np.float64)
        if keys[-1] == "kernel":
            array = array.transpose(3, 2, 0, 1) if array.ndim == 4 else array.T
        out[".".join(keys[:-1] + [names[keys[-1]]])] = array
    return out


def hold_against_flax(flax_module, torch_module, shape, seed=0, flax_module64=None):
    """Hold ``torch_module`` (NCHW in and out, or 2-D out) against
    ``flax_module`` (NHWC) on seeded variables bridged by ``flax_to_state_dict``
    and a seeded input of NHWC ``shape``: in eval mode in float32 within
    1e-5·max|ref|, and in train mode in float64 within 1e-10·max|ref| with every
    BatchNorm statistic after the forward within 1e-10 of its largest entry.
    The float64 module is ``flax_module.clone(dtype=float64)`` unless
    ``flax_module64`` is given (for a module without a ``dtype``). Returns the
    flax variables."""
    import jax
    import jax.numpy as jnp
    import torch

    from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    shapes = jax.eval_shape(flax_module.init, jax.random.key(0), jnp.zeros((1,) + shape[1:]))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    torch_module.load_state_dict(flax_to_state_dict(variables, torch_module), strict=True)

    def nhwc(t):
        t = t.detach()
        return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    want = np.asarray(jax.jit(lambda v, a: flax_module.apply(v, a))(variables, x))
    with torch.no_grad():
        got = nhwc(torch_module.float().eval()(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    x64 = x.astype(np.float64) + rng.normal(0, 1e-3, shape)
    with jax.enable_x64(True):
        module = flax_module64 or flax_module.clone(dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, mutated = jax.jit(lambda v, a: module.apply(v, a, train=True,
                                                          mutable=["batch_stats"]))(cast, x64)
        want = np.asarray(want)
        stats = by_torch_name(mutated.get("batch_stats", {}))
    net = torch_module.double().train()
    with torch.no_grad():
        got = nhwc(net(nchw(x64)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    state = net.state_dict()
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    for key, w in stats.items():
        assert np.abs(state[key].numpy() - w).max() <= 1e-10 * np.abs(w).max(), key
    return variables


def tiny_flax_detector(out_filters):
    """The three-scale flax stand-in of ``tests/test_moco_distill.py``: a
    stride-8 conv + BatchNorm + relu, then heads at strides 8, 16 and 32, each
    a 1 × 1 conv of ``out_filters``; returns (h1, h2, h3), coarsest first."""
    import flax.linen as nn

    class Tiny(nn.Module):
        out_filters: int

        @nn.compact
        def __call__(self, x, train: bool = False):
            h = nn.Conv(8, (3, 3), strides=(8, 8), padding="SAME")(x)
            h = nn.BatchNorm(use_running_average=not train, momentum=0.99, epsilon=1e-3)(h)
            h = nn.relu(h)
            h3 = nn.Conv(self.out_filters, (1, 1))(h)
            h = nn.relu(nn.Conv(8, (3, 3), strides=(2, 2), padding="SAME")(h))
            h2 = nn.Conv(self.out_filters, (1, 1))(h)
            h = nn.relu(nn.Conv(8, (3, 3), strides=(2, 2), padding="SAME")(h))
            h1 = nn.Conv(self.out_filters, (1, 1))(h)
            return h1, h2, h3

    return Tiny(out_filters)


def tiny_torch_detector(out_filters):
    """The torch twin of ``tiny_flax_detector`` under flax's names, NHWC images
    in, NHWC heads out, ``channels_last`` inside like the port's towers."""
    import torch
    import torch.nn as tnn
    import torch.nn.functional as F

    from tmv_tpu_torch.models.layers.common import BatchNorm, conv2d_same

    class TinyTorch(tnn.Module):
        def __init__(self):
            super().__init__()
            self.Conv_0 = tnn.Conv2d(3, 8, 3)
            self.BatchNorm_0 = BatchNorm(8, eps=1e-3, momentum=0.01)
            for i, cin in ((1, 8), (3, 8), (5, 8)):
                self.add_module(f"Conv_{i}", tnn.Conv2d(cin, out_filters, 1))
            self.Conv_2 = tnn.Conv2d(8, 8, 3)
            self.Conv_4 = tnn.Conv2d(8, 8, 3)

        def forward(self, images):
            x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            h = F.relu(self.BatchNorm_0(conv2d_same(x, self.Conv_0.weight, self.Conv_0.bias, 8)))
            h3 = self.Conv_1(h)
            h = F.relu(conv2d_same(h, self.Conv_2.weight, self.Conv_2.bias, 2))
            h2 = self.Conv_3(h)
            h = F.relu(conv2d_same(h, self.Conv_4.weight, self.Conv_4.bias, 2))
            h1 = self.Conv_5(h)
            return tuple(t.permute(0, 2, 3, 1) for t in (h1, h2, h3))

    return TinyTorch()
