"""The port's mosaic (``tmv_tpu_torch.data.mosaic``) against the JAX package's.

- ``mosaic_batch`` fed the same ``partners`` and ``centers`` as
  ``tmv_tpu.data.mosaic.mosaic_batch``, at ``prob`` 1 and 0, on float and on
  uint8 staged images (B = 4, 64 × 48 px, N = 6, with duplicate-area and
  invalid boxes): float pixels within 1e-4 on the 0-255 scale, uint8 within
  one step, boxes within 1e-4 px, classes and valid exactly, in JAX's tie order
  (``jax.lax.top_k`` puts the lower index first among equal ranks).
- The geometry cases of ``tests/test_mosaic.py``: boxes at the closed-form
  affine image of their source box, each quadrant's content from its source,
  ``prob`` 0 the identity, a box that collapses below 1 px dropped.
- ``draw_mosaic_params``: three permutations, centers in the range, the gate's
  share.
- ``YoloDataPipeline(mosaic=1.0)`` at 64 px on the CPU yields batches whose
  draws are the mosaic's and the augmentation's in that order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu.data.mosaic import mosaic_batch as jax_mosaic_batch
from tmv_tpu_torch.data import yolo_pipeline
from tmv_tpu_torch.data.mosaic import draw_mosaic_params, mosaic_batch

B, H, W, N = 4, 48, 64, 6
PARTNERS = np.array([[1, 2, 3, 0], [2, 3, 0, 1], [3, 0, 1, 2]])


def staged_case(rng, dtype):
    """Images, boxes with a duplicate row (equal areas) per image, classes, and
    valid with five rows set, so that every mosaic keeps invalid rows."""
    images = rng.uniform(0, 255, (B, H, W, 3)).astype(dtype)
    corners = np.sort(rng.uniform(0, 1, (B, N, 2, 2)), axis=2) * [W, H]
    boxes = corners.transpose(0, 1, 3, 2).reshape(B, N, 4)[..., [0, 2, 1, 3]]
    boxes = boxes.astype(np.float32)
    boxes[:, 1] = boxes[:, 0]
    classes = rng.integers(0, 5, (B, N)).astype(np.int32)
    valid = np.zeros((B, N), bool)       # fewer valid boxes than N: -1 ranks tie
    valid[0, :2] = valid[1, 0] = valid[2, 3] = valid[3, 1] = True
    return images, boxes, classes, valid


def run_both(images, boxes, classes, valid, partners, centers, prob):
    want = jax_mosaic_batch(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(classes),
                            jnp.asarray(valid), jax.random.key(0), prob=prob,
                            partners=jnp.asarray(partners, jnp.int32),
                            centers=jnp.asarray(centers, jnp.float32))
    gate = torch.full((images.shape[0],), prob > 0)
    got = mosaic_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                       torch.from_numpy(classes), torch.from_numpy(valid),
                       torch.as_tensor(partners), torch.as_tensor(centers, dtype=torch.float32),
                       gate)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("prob", [1.0, 0.0])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_mosaic_matches_jax(rng, dtype, prob):
    images, boxes, classes, valid = staged_case(rng, dtype)
    partners, centers, _ = draw_mosaic_params(torch.Generator().manual_seed(3), B, (W, H))
    (gi, gb, gc, gv), (wi, wb, wc, wv) = run_both(images, boxes, classes, valid,
                                                  partners.numpy(), centers.numpy(), prob)
    assert gi.dtype == images.dtype and gi.shape == images.shape
    if dtype == np.uint8:
        assert np.abs(gi.astype(np.int16) - wi.astype(np.int16)).max() <= 1
    else:
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gv, wv)
    if prob == 0.0:
        np.testing.assert_array_equal(gi, images)
        np.testing.assert_array_equal(gb, boxes)
    else:
        assert 0 < gv.sum() < gv.size       # invalid rows ranked last, in index order


def test_boxes_track_quadrant_affines():
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    images = np.stack([np.full((64, 64, 3), c, np.float32) for c in colors])
    src = np.array([[[8, 8, 40, 24]], [[0, 0, 64, 64]], [[16, 32, 48, 40]], [[10, 20, 30, 60]]],
                   np.float32)
    cx, cy = 24.0, 40.0
    centers = np.tile([[cx, cy]], (4, 1))
    (_, gb, gc, gv), _ = run_both(images, src, np.arange(4, dtype=np.int32)[:, None],
                                  np.ones((4, 1), bool), PARTNERS, centers, 1.0)
    rects = {0: (0, 0, cx, cy), 1: (cx, 0, 64, cy), 2: (0, cy, cx, 64), 3: (cx, cy, 64, 64)}
    expected = {}
    for q, (x0, y0, x1, y1) in rects.items():
        sx, sy = (x1 - x0) / 64, (y1 - y0) / 64
        b = src[q, 0]
        expected[q] = [b[0] * sx + x0, b[1] * sy + y0, b[2] * sx + x0, b[3] * sy + y0]
    best = max(expected, key=lambda q: (expected[q][2] - expected[q][0])
               * (expected[q][3] - expected[q][1]))
    assert gv[0, 0] and gc[0, 0] == best
    np.testing.assert_allclose(gb[0, 0], expected[best], rtol=1e-5, atol=1e-3)


def test_quadrant_content_identity_and_tiny_boxes():
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    images = np.stack([np.full((64, 64, 3), c, np.float32) for c in colors])
    empty = (np.zeros((4, 2, 4), np.float32), np.zeros((4, 2), np.int32), np.zeros((4, 2), bool))
    (gi, *_), _ = run_both(images, *empty, PARTNERS, np.tile([[32.0, 32.0]], (4, 1)), 1.0)
    for (y, x), color in zip([(8, 8), (8, 56), (56, 8), (56, 56)], colors):
        np.testing.assert_allclose(gi[0, y, x], color)
    # a 3 px wide box maps below 1 px in the 16 px wide TL tile: only a wide tile's survives
    boxes = np.tile(np.array([[[30, 30, 33, 60]]], np.float32), (4, 1, 1))
    (_, gb, _, gv), _ = run_both(np.zeros((4, 64, 64, 3), np.float32), boxes,
                                 np.zeros((4, 1), np.int32), np.ones((4, 1), bool), PARTNERS,
                                 np.tile([[16.0, 32.0]], (4, 1)), 1.0)
    assert gv[0, 0] and gb[0, 0, 2] - gb[0, 0, 0] > 1.0


def test_draw_mosaic_params():
    partners, centers, gate = draw_mosaic_params(torch.Generator().manual_seed(0), 64, (100, 50),
                                                 prob=0.5)
    assert partners.shape == (3, 64) and centers.shape == (64, 2) and gate.dtype == torch.bool
    for row in partners:
        assert sorted(row.tolist()) == list(range(64))
    assert float(centers[:, 0].min()) >= 30 and float(centers[:, 0].max()) <= 70
    assert float(centers[:, 1].min()) >= 15 and float(centers[:, 1].max()) <= 35
    assert 16 < int(gate.sum()) < 48


def test_pipeline_runs_mosaic_before_the_augmentation(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (80, 120, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}.jpg")
    (tmp_path / "classes.txt").write_text("cat\ndog\n")
    (tmp_path / "labels.txt").write_text("".join(
        f"im{i}.jpg|cat,10,10,60,50|dog,70,30,110,70|\n" for i in range(4)))
    anchors = np.array([[[116, 90], [156, 198], [373, 326]], [[30, 61], [62, 45], [59, 119]],
                        [[10, 13], [16, 30], [33, 23]]], np.float32)
    calls = []
    real = yolo_pipeline.mosaic_batch

    def spy(*args):
        calls.append(args[4:])
        return real(*args)

    monkeypatch.setattr(yolo_pipeline, "mosaic_batch", spy)
    args = (str(tmp_path), str(tmp_path / "labels.txt"), str(tmp_path / "classes.txt"), 4,
            anchors)
    pipe = yolo_pipeline.YoloDataPipeline(*args, image_wh=(64, 64), mosaic=1.0, prefetch=0,
                                          seed=2, device="cpu")
    batch = next(iter(pipe))
    assert batch["image"].shape == (4, 64, 64, 3) and len(calls) == 1
    assert all(np.isfinite(t.numpy()).all() for t in batch["targets"])
    # the draws: mosaic first, then the augmentation, from the pipeline's generator
    gen = torch.Generator().manual_seed(2)
    partners, centers, gate = draw_mosaic_params(gen, 4, (64, 64), prob=1.0)
    for got, want in zip(calls[0], (partners, centers, gate)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert gate.all()
    params = yolo_pipeline.draw_augment_params(gen, 4)
    again = yolo_pipeline.YoloDataPipeline(*args, image_wh=(64, 64), prefetch=0, seed=2,
                                           device="cpu")
    labels = iter(again.sampler)
    staged = [torch.from_numpy(a) for a in again.stage_batch([next(labels) for _ in range(4)])]
    imgs, boxes, _, valid = real(*staged, partners, centers, gate)
    want, _, _ = yolo_pipeline.augment_batch(imgs, boxes, valid, params, (64, 64))
    assert torch.equal(batch["image"], want)
