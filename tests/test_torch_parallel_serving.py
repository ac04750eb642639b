"""Sharded serving and a 4-rank dry run of the data axis, on the CPU.

- ``make_sharded_batched_predictor`` over ``[cpu, cpu]`` equals the one-device
  batched predictor exactly (valid rows, ids, boxes, scores) for a seeded YOLOv3 @64
  and a D0 @64; the ``MicroBatcher`` drives a sharded predictor as JAX's
  ``TestShardedMicroBatcher`` does; ``serve``'s ``--dp`` rules are JAX's, and more
  replicas than the host's cards are refused.
- A dry run of ``dryrun_multichip``'s kind for the data axis over 4 gloo ranks: a
  tiny D0 (32 px) train step under DP and under FSDP completes with finite
  parameters equal on every rank (and FSDP's equal to DP's).

The ranks start with the module and run while the serving tests run here.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from torch_port_cases import write_tiny_set
from tmv_tpu_torch.cli import serve
from tmv_tpu_torch.parallel import make_sharded_batched_predictor, shard_predict
from tmv_tpu_torch.parallel.inference import replica_devices
from tmv_tpu_torch.serving.batching import MicroBatcher


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The dry run's ranks (one CPU thread each), started before the first test of the
    module; this process keeps 2 CPU threads meanwhile."""
    with cases.threads(2):
        yield {"dry": cases.Ranks("dryrun_worker", 4, tmp_path_factory.mktemp("dryrun"),
                                  threads=1), "results": None}


def results(ranks):
    if ranks["results"] is None:
        ranks["results"] = ranks["dry"].results()
    return ranks["results"]


def seeded_yolo_v3(size):
    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.layers.common import init_weights

    model, iou_type = build_yolo_model("v3", 3, 3, device="cpu")
    init_weights(model, 0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    return model.eval(), iou_type


@pytest.mark.parametrize("family", ["yolo_v3", "d0"])
def test_sharded_predictor_equals_one_device(family):
    """Over ``[cpu, cpu]`` (two replicas, each on its own thread) the batch of 4
    splits in order and every output equals the one-device predictor's exactly."""
    size = 64
    if family == "yolo_v3":
        from tmv_tpu_torch.models.detector_harness import make_yolo_predict_batched

        model, iou_type = seeded_yolo_v3(size)
        anchors = cases.COCO_ANCHORS * size / 416

        def make(m):
            return make_yolo_predict_batched(m, (size, size), anchors, 3, confidence_thresh=0.0,
                                             scores_thresh=0.0, max_output_size=16,
                                             iou_type=iou_type)
    else:
        from tmv_tpu_torch.models.efficientdet.harness import (
            build_efficientdet, make_efficientdet_predict_batched,
        )
        from tmv_tpu_torch.models.efficientdet.net import init_weights

        model, anchors = build_efficientdet("efficientdet-d0", 3, size, device="cpu")
        init_weights(model, 0)
        with torch.no_grad():   # foreground above the prior, so boxes survive the threshold
            model.class_net.net.predict.pointwise.bias.fill_(1.0)
        model.eval()

        def make(m):
            return make_efficientdet_predict_batched(m, anchors, size)
    images = np.random.default_rng(3).uniform(size=(4, size, size, 3)).astype(np.float32)
    ref = make(model)(None, images)
    sharded, variables, devices = make_sharded_batched_predictor(model, make,
                                                                 devices=["cpu", "cpu"])
    try:
        out = sharded(variables, images)
    finally:
        sharded.close()
    assert variables is None and len(devices) == 2
    valid = ref[-1]
    assert valid.any()
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o, r)


def test_micro_batcher_over_a_sharded_predictor():
    """JAX's ``test_queue_over_sharded_predictor``: five concurrent requests through a
    queue of capacity 8 over 4 replicas equal the direct computation (rel 1e-5)."""
    def batched(variables, images):
        s = np.sum(images, axis=(1, 2, 3)) * 3.0
        return (s, s * 2.0)

    sharded = shard_predict([batched] * 4, ["cpu"] * 4)
    batcher = MicroBatcher(sharded, None, max_batch=8, max_wait_ms=5.0)
    imgs = np.random.default_rng(0).uniform(size=(5, 4, 4, 3)).astype(np.float32)
    try:
        with ThreadPoolExecutor(5) as pool:
            outs = list(pool.map(batcher.predict_one, list(imgs)))
    finally:
        batcher.close()
        sharded.close()
    for img, (a, b) in zip(imgs, outs):
        expect = float(img.sum()) * 3.0
        assert a == pytest.approx(expect, rel=1e-5)
        assert b == pytest.approx(2 * expect, rel=1e-5)
    with pytest.raises(ValueError, match="does not split over 4 replicas"):
        sharded(None, imgs[:5])


def test_serve_dp_rules_are_jaxs(tmp_path, capsys):
    (tmp_path / "c.txt").write_text("a\nb\n")
    (tmp_path / "a.txt").write_text("1,1, 2,2, 3,3, 4,4, 5,5, 6,6, 7,7, 8,8, 9,9\n")
    yolo = ["--classesFile", str(tmp_path / "c.txt"), "--anchorsFile", str(tmp_path / "a.txt"),
            "--randomInit"]
    d0 = ["--classesFile", str(tmp_path / "c.txt"), "--family", "efficientdet", "--randomInit"]
    assert serve.parse_args(yolo + ["--dp", "2", "--batch", "16"]).dp == 2
    assert serve.parse_args(d0 + ["--dp", "4", "--batch", "64"]).dp == 4
    assert serve.parse_args(yolo + ["--dp", "2", "--batch", "16", "--int8Static", "c",
                                    "--int8PerChannel"]).int8Static == "c"
    for argv, why in ((yolo + ["--dp", "2"], "--dp requires --batch > 1"),
                      (yolo + ["--dp", "3", "--batch", "16"], "not divisible by --dp 3"),
                      (d0 + ["--dp", "3", "--batch", "16"], "--dp requires --batch > 1 divisible"),
                      (["--classesFile", "c", "--artifact", "m.tmvt", "--dp", "2"],
                       "--dp cannot be combined with --artifact"),
                      (yolo + ["--spatial", "2", "--dp", "2", "--batch", "16"],
                       "--spatial is the latency direction: --batch 1, no --dp")):
        with pytest.raises(SystemExit):
            serve.parse_args(argv)
        assert why in capsys.readouterr().err


def test_more_replicas_than_cards_are_refused():
    """Asked for ``cuda`` on a host with fewer cards (none here), ``--dp`` stops with
    the reason; ``serve`` turns it into its exit message."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {have + 1} GPUs; this host has {have}"):
        replica_devices(have + 1, device="cuda")
    with pytest.raises(ValueError, match="GPUs"):
        make_sharded_batched_predictor(torch.nn.Linear(1, 1), lambda m: m, have + 1)
    assert replica_devices(2, device="cpu") == [torch.device("cpu")] * 2


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_dryrun_tiny_d0_over_four_ranks(ranks, mode):
    """The step completes on every rank: loss finite, parameters finite and equal on
    every rank; FSDP's within 1e-5·max|leaf| + 1e-7 of DP's."""
    got = results(ranks)
    first = got[0][mode][-1]
    assert np.isfinite(first["metrics"]["loss"])
    for key, value in first["model"].items():
        if value.is_floating_point():
            assert torch.isfinite(value).all(), key
        for other in got[1:]:
            assert other[mode][-1]["digest"][key] == first["digest"][key], key
    if mode == "fsdp":
        dp = got[0]["dp"][-1]["model"]
        for key, value in first["model"].items():
            if value.is_floating_point():
                np.testing.assert_allclose(value.numpy(), dp[key].numpy(), rtol=0,
                                           atol=1e-5 * dp[key].abs().max().item() + 1e-7)


@pytest.mark.parametrize("family, option", [("yolo", None), ("yolo", "mosaic"),
                                            ("d0", "host"), ("d0", "device")])
def test_pipelines_yield_each_rank_its_rows(tmp_path, family, option):
    """Two ranks' pipelines (``rows`` of ``shard_rows``) yield, concatenated, exactly
    the one-process pipeline's global batch of 8 (images and targets, two batches);
    without the mosaic each rank decodes only its 4 rows."""
    from tmv_tpu_torch.parallel.mesh import shard_rows

    files = write_tiny_set(tmp_path)

    def pipeline(rows):
        if family == "yolo":
            from tmv_tpu_torch.data.loaders import load_anchors
            from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline

            return YoloDataPipeline(files["images"], files["labels"], files["classes"], 8,
                                    load_anchors(files["anchors"]), image_wh=(64, 64),
                                    mosaic=1.0 if option == "mosaic" else 0.0, prefetch=0,
                                    device="cpu", rows=rows)
        from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline
        from tmv_tpu_torch.ops.anchors import Anchors

        anchors = Anchors(3, 7, (64, 64), 3, [(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)], 4.0)
        return EfficientDetPipeline(files["images"], files["labels"], files["classes"], 8,
                                    anchors, 4, image_size=64, device_aug=option == "device",
                                    prefetch=0, device="cpu", rows=rows)

    def flat(batch):
        return [t for v in batch.values() for t in (v if isinstance(v, tuple) else (v,))]

    whole = iter(pipeline(None))
    shares = [pipeline(shard_rows(8, r, 2)) for r in range(2)]
    decoded = [0, 0]
    if option is None:
        for r, share in enumerate(shares):
            def counted(label, r=r, stage=share.stage_one):
                decoded[r] += 1
                return stage(label)
            share.stage_one = counted
    iters = [iter(share) for share in shares]
    for _ in range(2):
        want = flat(next(whole))
        got = [flat(next(it)) for it in iters]
        for w, g0, g1 in zip(want, *got):
            assert torch.equal(torch.cat([g0, g1]), w)
    if option is None:
        assert decoded == [8, 8]
