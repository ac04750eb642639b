"""The port's YOLO data path against the JAX package's, on the CPU.

- ``load_labels`` and ``ClassBalancedSampler``: the same label dicts, and the same
  first 200 labels for two seeds with ``label_mean`` on and off (exact).
- ``make_yolo_targets`` (one image and a batch) and ``pad_labels``: exactly equal,
  with colliding boxes, boxes on the image's right and bottom edges, boxes past
  it, and all-invalid rows.
- The augmentation: JAX's ``_augment_one(key)`` against the port's
  ``augment_batch`` fed the numbers JAX drew from that key (its ``split(key, 7)``
  and ``hsv_shift``'s ``split(k_hsv, 5)`` reproduced here): images within 1e-5,
  boxes and valid exactly. ``rgb_to_hsv``/``hsv_to_rgb`` within 1e-6.
- ``YoloDataPipeline(image_random=False)`` on a tiny PNG set: the port's targets
  equal the JAX pipeline's exactly, its images within one float32 step below 1
  (6e-8): inside ``jit`` XLA turns ``/ 255`` into ``× (1/255)``, the port divides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu.data import image_ops as jax_image_ops
from tmv_tpu.data.loaders import load_labels as jax_load_labels
from tmv_tpu.data.samplers import ClassBalancedSampler as JaxSampler
from tmv_tpu.data.yolo_pipeline import YoloDataPipeline as JaxPipeline
from tmv_tpu.data.yolo_pipeline import _augment_one
from tmv_tpu.data.yolo_targets import make_yolo_targets as jax_targets
from tmv_tpu.data.yolo_targets import pad_labels as jax_pad_labels
from tmv_tpu_torch.data import image_ops
from tmv_tpu_torch.data.loaders import load_labels
from tmv_tpu_torch.data.samplers import ClassBalancedSampler
from tmv_tpu_torch.data.yolo_pipeline import AUG_PARAMS, YoloDataPipeline, augment_batch
from tmv_tpu_torch.data.yolo_targets import make_yolo_targets, pad_labels

ANCHORS = np.array([[[32, 28], [40, 44], [60, 50]],
                    [[14, 18], [20, 16], [24, 30]],
                    [[4, 6], [8, 7], [10, 12]]], np.float32)
NAMES = ["red", "green", "blue"]


def write_set(root, rng, n=6, hw=(48, 40), ext="png"):
    """``n`` random images with 0-4 labelled boxes each (a bad class and a
    degenerate box mixed in), and the classes file."""
    os.makedirs(root / "imgs", exist_ok=True)
    lines = []
    for i in range(n):
        h, w = hw
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.{ext}")
        entries = []
        for _ in range(int(rng.integers(0, 5))):
            x1, y1 = rng.integers(0, w - 8), rng.integers(0, h - 8)
            entries.append(f"{NAMES[rng.integers(3)]},{x1},{y1},{x1 + rng.integers(3, 9)},"
                           f"{y1 + rng.integers(3, 9)}")
        if i == 1:
            entries += ["purple,1,1,5,5", "red,5,5,5,9"]
        lines.append(f"im{i}.{ext}|{'|'.join(entries)}|")
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(NAMES) + "\n")
    return str(root / "imgs"), str(root / "labels.txt"), str(root / "classes.txt")


def test_load_labels_matches_jax(tmp_path, rng):
    images, labels_file, _ = write_set(tmp_path, rng)
    got, n = load_labels(labels_file, images, NAMES)
    want, m = jax_load_labels(labels_file, images, NAMES)
    assert n == m == 6
    for g, w in zip(got, want):
        assert g["image_path"] == w["image_path"] and g["classes"] == w["classes"]
        np.testing.assert_array_equal(g["boxes"], w["boxes"])


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("label_mean", [True, False])
def test_sampler_sequence_matches_jax(seed, label_mean):
    rng = np.random.default_rng(5)
    labels = [{"image_path": f"im{i}.jpg",
               "classes": list(rng.integers(0, 5, rng.integers(0, 4)))} for i in range(23)]
    got = iter(ClassBalancedSampler(labels, label_mean, seed))
    want = iter(JaxSampler(labels, label_mean, seed))
    assert ([next(got)["image_path"] for _ in range(200)]
            == [next(want)["image_path"] for _ in range(200)])


def targets_case(rng, image_wh=(64, 96), m=12):
    """Padded boxes with a collision, edge boxes, a box past the image and
    invalid padding."""
    w, h = image_wh
    x1 = rng.uniform(0, w - 20, m)
    y1 = rng.uniform(0, h - 20, m)
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, 40, m), y1 + rng.uniform(2, 40, m)], -1)
    boxes = np.round(boxes).astype(np.float32)
    boxes[1] = boxes[0]                                   # collision
    boxes[2] = [w - 10, h - 12, w, h]                     # centre on the right/bottom edge
    boxes[3] = [w - 2, 4, w + 30, 20]                     # centre past the image
    boxes[4] = [0, 0, 1, 1]                               # tiny box at the origin
    classes = rng.integers(0, 4, m).astype(np.int32)
    valid = rng.uniform(size=m) > 0.2
    valid[:5] = True
    valid[-2:] = False
    return boxes, classes, valid


@pytest.mark.parametrize("image_wh", [(64, 96), (96, 64)])
def test_make_yolo_targets_exactly_equal(rng, image_wh):
    cases = [targets_case(rng, image_wh) for _ in range(3)]
    cases.append(tuple(np.zeros_like(a) for a in cases[0]))          # all-invalid row
    want = [[np.asarray(t) for t in jax_targets(jnp.asarray(b), jnp.asarray(c), jnp.asarray(v),
                                                 ANCHORS, image_wh, 4)] for b, c, v in cases]
    batch = [torch.from_numpy(np.stack(a)) for a in zip(*cases)]
    got = [t.numpy() for t in make_yolo_targets(*batch, ANCHORS, image_wh, 4)]
    for i, (b, c, v) in enumerate(cases):
        one = make_yolo_targets(torch.from_numpy(b), torch.from_numpy(c), torch.from_numpy(v),
                                ANCHORS, image_wh, 4)
        for s in range(3):
            np.testing.assert_array_equal(got[s][i], want[i][s])
            np.testing.assert_array_equal(one[s].numpy(), want[i][s])
    assert sum(float(w[..., 4].sum()) for w in want[0]) >= 3   # boxes landed


def test_pad_labels_exactly_equal(rng):
    boxes = rng.uniform(0, 50, (7, 4)).astype(np.float32)
    for n, cap in ((0, 5), (3, 5), (7, 5), (7, 7)):
        for g, w in zip(pad_labels(boxes[:n], list(range(n)), cap),
                        jax_pad_labels(boxes[:n], list(range(n)), cap)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def jax_draws(key, jitter, hue, sat, val):
    """The numbers ``_augment_one`` draws from ``key``, in ``AUG_PARAMS`` order."""
    u = jax.random.uniform
    k_ar1, k_ar2, k_scale, k_dx, k_dy, k_flip, k_hsv = jax.random.split(key, 7)
    kh, ks1, ks2, kv1, kv2 = jax.random.split(k_hsv, 5)
    draws = [u(k_ar1, (), minval=1 - jitter, maxval=1 + jitter),
             u(k_ar2, (), minval=1 - jitter, maxval=1 + jitter),
             u(k_scale, (), minval=0.25, maxval=2.0), u(k_dx, (), minval=0.0, maxval=1.0),
             u(k_dy, (), minval=0.0, maxval=1.0), u(k_flip),
             u(kh, (), minval=-hue, maxval=hue), u(ks1, (), minval=1.0, maxval=sat), u(ks2),
             u(kv1, (), minval=1.0, maxval=val), u(kv2)]
    return [float(d) for d in draws]


def test_augmentation_with_jax_draws(rng):
    image_wh, src = (64, 48), (48, 64)
    n = 12
    imgs = rng.integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)
    boxes = np.stack([targets_case(rng, image_wh, 10)[0] for _ in range(n)])
    valid = rng.uniform(size=(n, 10)) > 0.3
    want, draws = [], []
    for i in range(n):
        key = jax.random.key(100 + i)
        out = _augment_one(jnp.asarray(imgs[i]), jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
                           key, image_wh, 0.3, 0.1, 1.5, 1.5, True, src)
        want.append([np.asarray(o) for o in out])
        draws.append(jax_draws(key, 0.3, 0.1, 1.5, 1.5))
    params = {k: torch.tensor([d[j] for d in draws], dtype=torch.float32)
              for j, k in enumerate(AUG_PARAMS)}
    got = augment_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                        torch.from_numpy(valid), params, image_wh)
    flips = 0
    for i in range(n):
        np.testing.assert_allclose(got[0][i].numpy(), want[i][0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[1][i].numpy(), want[i][1])
        np.testing.assert_array_equal(got[2][i].numpy(), want[i][2])
        flips += draws[i][5] < 0.5
    assert 0 < flips < n


def test_hsv_round_trip_matches_jax(rng):
    rgb = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    rgb[0, :3] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 0, 0]]       # grey, black, pure red
    hsv = image_ops.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(hsv, np.asarray(jax_image_ops.rgb_to_hsv(jnp.asarray(rgb))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(image_ops.hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               np.asarray(jax_image_ops.hsv_to_rgb(jnp.asarray(hsv))),
                               rtol=0, atol=1e-6)
    boxes = rng.uniform(0, 64, (9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        image_ops.flip_boxes_lr(torch.from_numpy(boxes), 64.0).numpy(),
        np.asarray(jax_image_ops.flip_boxes_lr(jnp.asarray(boxes), 64.0)))


def test_pipeline_without_random_matches_jax(tmp_path, rng):
    images, labels_file, classes_file = write_set(tmp_path, rng, n=5)
    kw = dict(image_wh=(64, 32), image_random=False, label_mean=False, seed=3, prefetch=0)
    port = YoloDataPipeline(images, labels_file, classes_file, 2, ANCHORS, device="cpu", **kw)
    ref = JaxPipeline(images, labels_file, classes_file, 2, ANCHORS, **kw)
    got_it, want_it = iter(port), iter(ref)
    for _ in range(4):
        got, want = next(got_it), next(want_it)
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                                   rtol=0, atol=6e-8)
        for g, w in zip(got["targets"], want["targets"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got_it.close()


def test_pipeline_prefetch_thread_and_refusals(tmp_path, rng):
    images, labels_file, classes_file = write_set(tmp_path, rng, n=4)
    args = (images, labels_file, classes_file, 2, ANCHORS)
    sync = iter(YoloDataPipeline(*args, image_wh=(32, 32), seed=1, prefetch=0, device="cpu"))
    threaded = iter(YoloDataPipeline(*args, image_wh=(32, 32), seed=1, prefetch=2, device="cpu"))
    for _ in range(3):
        a, b = next(sync), next(threaded)
        np.testing.assert_array_equal(a["image"].numpy(), b["image"].numpy())
        assert a["image"].shape == (2, 32, 32, 3)
        assert float(a["image"].min()) >= 0 and float(a["image"].max()) <= 1
    threaded.close()
    # mosaic and the staging cache are ported: both options are taken
    ported = YoloDataPipeline(*args, image_wh=(32, 32), seed=1, prefetch=0, mosaic=0.5,
                              cache_dir=str(tmp_path / "cache"), device="cpu")
    assert ported.mosaic == 0.5 and ported.cache is not None
    assert next(iter(ported))["image"].shape == (2, 32, 32, 3)
    assert ported.cache.filled_count == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            YoloDataPipeline(*args)
