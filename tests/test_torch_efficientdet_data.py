"""The port's EfficientDet data path against the JAX package's, on the CPU.

- The host-augmentation pipeline (``EfficientDetPipeline``, seed 0, 64 px,
  B = 2) on a tiny PNG set: its first two batches equal the JAX pipeline's —
  images, raw boxes and classes exactly (the draws come from Python's ``random``
  and numpy generators seeded per item, the same in both); targets as
  ``generate_targets`` is held: masks and one-hot classes exactly, encoded boxes
  within 1e-6.
- The device augmentation: ``augment_batch`` fed the numbers JAX's
  ``efficientdet_augment_one`` drew from its keys (``split(key, 4)`` and
  ``salt_pepper``'s ``split(k_noise)`` reproduced here): images within 1e-5,
  boxes and validity exactly; and the device-augmentation batch (staging, H2D,
  augmentation, targets) fed those draws against the JAX pipeline's jitted
  ``_aug_targets_fn`` on the same staged arrays.
- The ``blur`` and ``random_noise`` copies equal the JAX package's.
- Refusals: ``cache_dir``; the pipeline's device defaults to the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu.data.device_aug import efficientdet_augment_one
from tmv_tpu.data.efficientdet_pipeline import EfficientDetPipeline as JaxPipeline
from tmv_tpu.ops.anchors import Anchors as JaxAnchors
from tmv_tpu.utils import image_helper as jax_image_helper
from tmv_tpu_torch.data.device_aug import augment_batch
from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline
from tmv_tpu_torch.models.efficientdet.harness import efficientdet_config
from tmv_tpu_torch.ops.anchors import Anchors
from tmv_tpu_torch.utils import image_helper
from torch_port_cases import one_torch_thread

SIZE = 64
NAMES = ["red", "green", "blue", "yellow"]
CLASSES = len(NAMES) + 1

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def write_set(root, rng, n=6):
    """``n`` random PNGs of 72 x 88 with 1-4 boxes of 16-48 px (so that anchors
    at 64 px match some), and the classes file."""
    os.makedirs(root / "imgs", exist_ok=True)
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (72, 88, 3), dtype=np.uint8)).save(
            root / "imgs" / f"im{i}.png")
        entries = []
        for _ in range(int(rng.integers(1, 5))):
            w, h = rng.integers(16, 48, 2)
            x1, y1 = rng.integers(0, 88 - w), rng.integers(0, 72 - h)
            entries.append(f"{NAMES[rng.integers(4)]},{x1},{y1},{x1 + w},{y1 + h}")
        lines.append(f"im{i}.png|{'|'.join(entries)}|")
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(NAMES) + "\n")
    return str(root / "imgs"), str(root / "labels.txt"), str(root / "classes.txt")


def anchor_pair():
    cfg = efficientdet_config("efficientdet-d0", CLASSES, SIZE)
    args = (cfg.min_level, cfg.max_level, (SIZE, SIZE), cfg.num_scales, cfg.aspect_ratios,
            cfg.anchor_scale)
    return Anchors(*args), JaxAnchors(*args)


def assert_targets_equal(got, want):
    """Per-level targets: masks and classes exactly, boxes within 1e-6."""
    for gb, gc, gm, wb, wc, wm in zip(got["boxes"], got["classes"], got["masks"],
                                      want["boxes"], want["classes"], want["masks"]):
        np.testing.assert_array_equal(gm.cpu().numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gc.cpu().numpy(), np.asarray(wc))
        np.testing.assert_allclose(gb.cpu().numpy(), np.asarray(wb), rtol=0, atol=1e-6)


def test_host_aug_pipeline_matches_jax_at_the_same_seed(tmp_path, rng):
    files = write_set(tmp_path, rng)
    anchors, janchors = anchor_pair()
    kw = dict(image_size=SIZE, max_boxes=8, seed=0, with_raw_boxes=True, prefetch=0)
    port = iter(EfficientDetPipeline(*files, 2, anchors, CLASSES, device="cpu", **kw))
    ref = iter(JaxPipeline(*files, 2, janchors, CLASSES, **kw))
    positives = 0
    for _ in range(2):
        got, want = next(port), next(ref)
        np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))
        assert len(got["raw"]) == len(want["raw"]) == 2
        for (gb, gc), (wb, wc) in zip(got["raw"], want["raw"]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gc, wc)
            assert gc.min() >= 1                    # background is 0
        assert_targets_equal(got, want)
        positives += sum(int(m.sum()) for m in got["masks"])
    port.close()
    assert positives > 0


def jax_device_draws(key, size):
    """The numbers ``efficientdet_augment_one`` draws from ``key``, as
    ``device_aug.draw_params`` lays them out (one image)."""
    k_blur, k_scale, k_off, k_noise = jax.random.split(key, 4)
    k_mask, k_col = jax.random.split(k_noise)
    return {"radius": jax.random.randint(k_blur, (), 0, 5),
            "scale": jax.random.uniform(k_scale, (2,), minval=0.5, maxval=2.0),
            "offset": jax.random.uniform(k_off, (2,), minval=-45.0, maxval=45.0),
            "noise": jax.random.uniform(k_mask, (size, size, 1)) < 0.02,
            "colors": jax.random.uniform(k_col, (size, size, 3))}


def stacked_draws(keys, size):
    draws = [jax_device_draws(k, size) for k in keys]
    return {name: torch.from_numpy(np.stack([np.asarray(d[name]) for d in draws]))
            for name in draws[0]}


def test_device_augmentation_with_jax_draws(rng):
    n = 8
    imgs = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    xy = rng.uniform(-10, SIZE, (n, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 40, (n, 6, 2))], -1).astype(np.float32)
    valid = rng.uniform(size=(n, 6)) > 0.2
    keys = [jax.random.key(40 + i) for i in range(n)]
    want = [[np.asarray(o) for o in efficientdet_augment_one(
        jnp.asarray(imgs[i]), jnp.asarray(boxes[i]), jnp.asarray(valid[i]), keys[i], SIZE)]
        for i in range(n)]
    params = stacked_draws(keys, SIZE)
    radii = params["radius"].tolist()
    assert 0 in radii and max(radii) > 0
    got = augment_batch(torch.from_numpy(imgs), torch.from_numpy(boxes),
                        torch.from_numpy(valid), params, SIZE)
    for i in range(n):
        np.testing.assert_allclose(got[0][i].numpy(), want[i][0], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[1][i].numpy(), want[i][1])
        np.testing.assert_array_equal(got[2][i].numpy(), want[i][2])
    assert 0 < int(got[2].sum()) < int(valid.sum())       # some boxes leave or shrink


def test_device_aug_batch_matches_jax_aug_targets(tmp_path, rng):
    files = write_set(tmp_path, rng, n=4)
    anchors, janchors = anchor_pair()
    kw = dict(image_size=SIZE, max_boxes=8, device_aug=True, prefetch=0)
    port = EfficientDetPipeline(*files, 4, anchors, CLASSES, device="cpu", **kw)
    ref = JaxPipeline(*files, 4, janchors, CLASSES, **kw)
    labels = port.labels[:4]
    staged = [ref._stage_fixed(lb) for lb in labels]
    imgs, boxes, classes, valid = (np.stack(z) for z in zip(*staged))
    key = jax.random.key(9)
    images01, boxes_t, classes_t, masks_t = ref._aug_targets_fn(
        jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid), key)
    params = stacked_draws(jax.random.split(key, 4), SIZE)
    staged_port = port.stage_batch(labels)
    for a, b in zip(staged_port, (imgs, boxes, classes, valid)):
        np.testing.assert_array_equal(a, b)
    got = port.device_batch(staged_port, params=params)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(images01), rtol=0, atol=1e-5)
    assert_targets_equal(got, {"boxes": boxes_t, "classes": classes_t, "masks": masks_t})
    assert sum(int(m.sum()) for m in got["masks"]) > 0

    batch = next(iter(port))                        # the generator's own draws
    assert batch["image"].shape == (4, SIZE, SIZE, 3) and batch["image"].dtype == torch.float32
    assert 0.0 <= float(batch["image"].min()) and float(batch["image"].max()) <= 1.0
    assert [m.shape for m in batch["masks"]] == [m.shape for m in got["masks"]]


def test_host_blur_and_noise_copies_match_jax(rng):
    img = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    for radius in (1, 3):
        np.testing.assert_array_equal(image_helper.blur(img, radius),
                                      jax_image_helper.blur(img, radius))
    np.testing.assert_array_equal(image_helper.random_noise(img, np.random.default_rng(4)),
                                  jax_image_helper.random_noise(img, np.random.default_rng(4)))


def test_pipeline_refusals_and_default_device(tmp_path, rng):
    files = write_set(tmp_path, rng, n=2)
    anchors, _ = anchor_pair()
    # the staging cache is ported: it is refused only without device augmentation
    with pytest.raises(ValueError, match="requires device_aug"):
        EfficientDetPipeline(*files, 2, anchors, CLASSES, cache_dir=str(tmp_path / "c"),
                             device="cpu")
    cached = EfficientDetPipeline(*files, 2, anchors, CLASSES, cache_dir=str(tmp_path / "c"),
                                  device_aug=True, device="cpu")
    assert cached.cache is not None and cached.cache.filled_count == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EfficientDetPipeline(*files, 2, anchors, CLASSES)
