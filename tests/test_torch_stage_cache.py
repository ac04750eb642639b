"""The port's staging cache (``tmv_tpu_torch.data.stage_cache``) and the
pipelines and eval CLI that stage through it, on the CPU.

- The cases of ``tests/test_stage_cache.py`` against the port's copy: a miss
  stages and fills, a hit serves the same arrays without staging; a reopened
  cache keeps its rows, and a changed fingerprint (``max_boxes``, the label
  list) rebuilds it; the fingerprint is the JAX package's for the same inputs.
- A cached epoch serves frames and labels bit-equal to uncached staging, for
  the YOLO pipeline (cold and warm cache, batches and every target) and for the
  EfficientDet pipeline's device augmentation; the warm epoch decodes nothing.
  The EfficientDet cache refuses the host-augmentation path, and the D0 trainer
  ``--cacheDir`` without ``--deviceAug``.
- ``eval_map --cacheDir --device cpu`` gives the same mAP as without the cache,
  cold and warm; the efficientdet family refuses ``--cacheDir``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu.data import stage_cache as jax_stage_cache
from tmv_tpu_torch.cli import eval_map, train_efficientdet
from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline
from tmv_tpu_torch.data.stage_cache import StageCache, _fingerprint, assign_rows
from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
from tmv_tpu_torch.ops.anchors import Anchors
from torch_port_cases import one_torch_thread, write_tiny_set  # noqa: F401 (fixture)

ANCHORS = np.asarray([[[6, 6], [8, 8], [10, 10]], [[12, 12], [16, 16], [20, 20]],
                      [[24, 24], [28, 28], [32, 32]]], np.float32)


@pytest.fixture()
def dataset(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "imgs").mkdir()
    lines = []
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (80, 96, 3)).astype(np.uint8)).save(
            tmp_path / "imgs" / f"im{i}.jpg", quality=92)
        lines.append(f"im{i}.jpg|a,10,12,40,46|b,50,20,70,60|")
    (tmp_path / "labels.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "classes.txt").write_text("a\nb\n")
    return tmp_path


def unit_labels(dataset, n=3):
    return [{"image_path": str(dataset / "imgs" / f"im{i}.jpg"),
             "boxes": [10.0, 12.0, 40.0, 46.0], "classes": [0]} for i in range(n)]


def test_miss_fill_hit_and_the_jax_fingerprint(dataset, tmp_path):
    labels = unit_labels(dataset)
    assign_rows(labels)
    assert _fingerprint(labels, (32, 32), 5, "t") == jax_stage_cache._fingerprint(
        labels, (32, 32), 5, "t")
    cache = StageCache(str(tmp_path / "c"), labels, (32, 32), 5)
    assert cache.filled_count == 0 and cache.get(0) is None
    calls = []

    def stage(lb):
        calls.append(lb["_cache_row"])
        v = np.zeros((5,), bool)
        v[0] = True
        return (np.full((32, 32, 3), lb["_cache_row"] + 7, np.uint8),
                np.zeros((5, 4), np.float32) + lb["_cache_row"], np.zeros((5,), np.int32), v)

    first = [np.array(x) for x in cache.wrap(labels[1], stage)]
    assert calls == [1] and cache.filled_count == 1
    second = [np.array(x) for x in cache.wrap(labels[1], stage)]
    assert calls == [1]
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert second[3].dtype == np.bool_


def test_reopen_persists_and_mismatch_rebuilds(dataset, tmp_path):
    labels = unit_labels(dataset)
    assign_rows(labels)
    d = str(tmp_path / "c")
    StageCache(d, labels, (32, 32), 5).put(2, np.zeros((32, 32, 3), np.uint8),
                                           np.zeros((5, 4), np.float32),
                                           np.zeros((5,), np.int32), np.ones((5,), bool))
    again = StageCache(d, labels, (32, 32), 5)
    assert again.filled_count == 1 and again.get(2) is not None
    assert StageCache(d, labels, (32, 32), 7).filled_count == 0
    more = unit_labels(dataset, n=4)
    assign_rows(more)
    assert StageCache(d, more, (32, 32), 7).filled_count == 0


def counted(pipe, attr):
    """Count the pipeline's uncached stagings (decodes)."""
    real = getattr(pipe, attr)
    calls = []

    def stage(label):
        calls.append(label["image_path"])
        return real(label)

    setattr(pipe, attr, stage)
    return calls


def test_yolo_batches_identical_with_and_without_cache(dataset, tmp_path):
    kwargs = dict(image_path=str(dataset / "imgs"), label_path=str(dataset / "labels.txt"),
                  classes_path=str(dataset / "classes.txt"), batch_size=2, anchors=ANCHORS,
                  image_wh=(64, 64), label_mean=False, seed=11, prefetch=0, device="cpu")

    def take(pipe, n=4):
        it = iter(pipe)
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    ref = take(YoloDataPipeline(**kwargs))
    cold_pipe = YoloDataPipeline(cache_dir=str(tmp_path / "c"), **kwargs)
    cold_decodes = counted(cold_pipe, "stage_one_uncached")
    cold = take(cold_pipe)
    assert cold_pipe.cache.filled_count == 6 and len(cold_decodes) == 6
    warm_pipe = YoloDataPipeline(cache_dir=str(tmp_path / "c"), **kwargs)
    warm_decodes = counted(warm_pipe, "stage_one_uncached")
    warm = take(warm_pipe)
    assert warm_decodes == []
    for a, b, c in zip(ref, cold, warm):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["image"], c["image"])
        for ta, tb, tc in zip(a["targets"], b["targets"], c["targets"]):
            assert torch.equal(ta, tb) and torch.equal(ta, tc)
    labels = iter(warm_pipe.sampler)
    for _ in range(3):
        label = next(labels)
        for got, want in zip(warm_pipe.stage_one(label), warm_pipe.stage_one_uncached(label)):
            np.testing.assert_array_equal(got, want)


def test_efficientdet_device_aug_batches_identical(dataset, tmp_path):
    anchors = Anchors(3, 7, (64, 64), 3, [(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)], 4.0)
    kwargs = dict(image_path=str(dataset / "imgs"), label_path=str(dataset / "labels.txt"),
                  classes_path=str(dataset / "classes.txt"), batch_size=2, anchors=anchors,
                  num_classes=3, image_size=64, augment=True, label_mean=False,
                  device_aug=True, seed=5, prefetch=0, device="cpu")
    a = next(iter(EfficientDetPipeline(**kwargs)))
    cached = EfficientDetPipeline(cache_dir=str(tmp_path / "c"), **kwargs)
    b = next(iter(cached))
    assert cached.cache.filled_count == 2
    warm = EfficientDetPipeline(cache_dir=str(tmp_path / "c"), **kwargs)
    decodes = counted(warm, "stage_fixed_uncached")
    c = next(iter(warm))
    assert decodes == []
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["image"], c["image"])
    for k in ("boxes", "classes", "masks"):
        for la, lb, lc in zip(a[k], b[k], c[k]):
            assert torch.equal(la, lb) and torch.equal(la, lc)
    with pytest.raises(ValueError, match="device_aug"):
        EfficientDetPipeline(**{**kwargs, "device_aug": False}, cache_dir=str(tmp_path / "d"))
    with pytest.raises(SystemExit):
        train_efficientdet.parse_args(["--trainData", "l", "--trainImagePath", "i",
                                       "--classesFile", "c", "--cacheDir", "x"])
    args = train_efficientdet.parse_args(["--trainData", "l", "--trainImagePath", "i",
                                          "--classesFile", "c", "--cacheDir", "x",
                                          "--deviceAug", "--remat"])
    assert (args.cacheDir, args.remat) == ("x", True)


def test_eval_cli_with_cache_matches_without(tmp_path, one_torch_thread):
    write_tiny_set(tmp_path)
    base = ["--imagePath", str(tmp_path / "imgs"), "--labelFile", str(tmp_path / "labels.txt"),
            "--classesFile", str(tmp_path / "classes.txt"), "--anchorsFile",
            str(tmp_path / "anchors.txt"), "--imageSize", "64", "--batchSize", "2",
            "--device", "cpu", "--mode", "global", "--variant", "voc"]
    plain = eval_map.main(base)
    cold = eval_map.main(base + ["--cacheDir", str(tmp_path / "c")])
    warm = eval_map.main(base + ["--cacheDir", str(tmp_path / "c")])
    assert plain["images"] == cold["images"] == warm["images"] == 4
    assert plain["mAP"] == cold["mAP"] == warm["mAP"]
    assert (tmp_path / "c" / "meta.json").exists()
    with pytest.raises(SystemExit):
        eval_map.parse_args(base + ["--family", "efficientdet", "--cacheDir", "c"])
