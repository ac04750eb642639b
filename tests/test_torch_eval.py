"""The port's YOLOv4 eval and training CLIs, on the CPU at 64 × 64.

- ``eval_map_step`` against the JAX package's on the same bridged seeded
  weights and batches (rtol 1e-6).
- ``cli/eval_map.py`` in ``--mode batch`` and ``global`` × ``--variant
  reference``, ``voc``, ``coco`` against ``tmv_tpu.cli.eval_map`` on the same
  weights (a JAX orbax checkpoint, and its bridged ``.pt``) and a tiny labelled
  PNG set whose labels are the model's own detections, so that the mAP is
  neither 0 nor 1: the same mAP (rtol 1e-6). The JAX predictor and the JAX
  checkpoint's restored variables are made once and reused across the JAX
  CLI's six runs.
- ``cli/train_yolo.py --device cpu``: two steps at ``--imageSize 64`` with a val
  set, leaving checkpoints that ``cli/eval_map.py`` reads; a rerun resumes at
  the saved step.
- Both CLIs refuse the flags they do not port and default to ``--device cuda``,
  which raises without a card; ``cli/eval_map.py --int8Static`` (per-tensor,
  ``--int8PerChannel``, ``--int8Margin 0.5``) calibrates on 16 images and records
  ``quant`` (and the margin) on the CPU.
- EfficientDet-D0 (64 px, 3 classes + background): ``cli/eval_map.py --family
  efficientdet`` in both modes × three variants against the JAX CLI on the same
  weights (a JAX orbax checkpoint and its bridged ``.pt``), on PNGs labelled
  with some of the model's own detections: the same mAP (rtol 1e-6), strictly
  between 0 and 1; the port's batched pred/gt rows equal the JAX harness's
  per-image ones, and ``make_efficientdet_eval``'s per-batch mAP JAX's. ``cli/train_efficientdet.py --device cpu`` takes two steps
  (``--accumSteps 2``) with checkpoints, resumes, and its checkpoint is scored;
  it refuses the flags it does not port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import tmv_tpu.models.detector_harness as jax_harness
import tmv_tpu.models.efficientdet.harness as jax_d0_harness
from tmv_tpu.cli import eval_map as jax_eval_cli
from tmv_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.data.efficientdet_pipeline import EfficientDetPipeline as JaxD0Pipeline
from tmv_tpu.data.yolo_pipeline import YoloDataPipeline as JaxPipeline
from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu.ops.anchors import Anchors as JaxAnchors
from tmv_tpu_torch.cli import eval_map, train_efficientdet, train_yolo
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline
from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
from tmv_tpu_torch.models.detector_harness import (
    eval_map_step, make_yolo_predict, make_yolo_predict_batched,
)
from tmv_tpu_torch.models.efficientdet.harness import (
    build_efficientdet, efficientdet_config, make_efficientdet_eval, make_efficientdet_pred_gt,
)
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from torch_port_cases import one_torch_thread, seeded_variables  # noqa: F401

SIZE = 64
NAMES = ["red", "green", "blue"]
# the converged tool's anchors at a 64 px input, coarsest scale first
ANCHORS = np.array([[[24, 24], [28, 28], [32, 32]], [[12, 12], [16, 16], [20, 20]],
                    [[6, 6], [8, 8], [10, 10]]])


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    """Seeded YOLOv4 (3 classes) as a JAX checkpoint and a ``.pt``, and 6 PNGs
    labelled with some of its own detections (jittered) plus a missed box."""
    root = tmp_path_factory.mktemp("eval_set")
    rng = np.random.default_rng(11)
    flax_model = FlaxYoloV4(classes_num=3)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    for name in ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2"):
        kernel = variables["params"][name]["Conv_0"]["kernel"]
        kernel[..., np.arange(kernel.shape[-1]) % 8 < 4] *= 1e-3
    net = YoloV4(classes_num=3)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    torch.save(net.state_dict(), root / "model.pt")
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], optax.sgd(1e-3))
    mgr = JaxCheckpointManager(str(root / "jax_ckpt"))
    mgr.save(0, state)
    mgr.close()

    os.makedirs(root / "imgs")
    images = rng.uniform(0, 1, (6, SIZE, SIZE, 3)).astype(np.float32)
    predict = make_yolo_predict_batched(net.eval(), (SIZE, SIZE), ANCHORS, 3,
                                        confidence_thresh=0.5, scores_thresh=0.2,
                                        iou_type="diou")
    pixels = (images * 255).round().astype(np.uint8)
    boxes, ids, _, valid = predict(None, pixels.astype(np.float32) / 255.0)
    lines = []
    for i in range(6):
        Image.fromarray(pixels[i]).save(root / "imgs" / f"im{i}.png")
        entries = []
        for b, c in list(zip(boxes[i][valid[i]], ids[i][valid[i]]))[:4]:
            x1, y1, x2, y2 = np.clip(b * SIZE + rng.uniform(-2, 2, 4), 0, SIZE)
            if x2 - x1 > 2 and y2 - y1 > 2:
                entries.append(f"{NAMES[c]},{x1:.1f},{y1:.1f},{x2:.1f},{y2:.1f}")
        entries.append(f"{NAMES[i % 3]},5,5,20,22")
        lines.append(f"im{i}.png|{'|'.join(entries)}|")
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(NAMES) + "\n")
    (root / "anchors.txt").write_text(", ".join(f"{w},{h}" for w, h in
                                                ANCHORS[::-1].reshape(-1, 2)) + "\n")
    return root, flax_model, variables, net


def cli_files(root):
    return ["--imagePath", str(root / "imgs"), "--labelFile", str(root / "labels.txt"),
            "--classesFile", str(root / "classes.txt"), "--anchorsFile",
            str(root / "anchors.txt"), "--imageSize", str(SIZE)]


@pytest.fixture(scope="module")
def jax_cli_cache():
    """The JAX CLI's ``make_yolo_predict`` and ``_restore_variables``, each made
    once per argument set, so that its runs share one compiled predictor and one
    orbax restore."""
    predictors, restored = {}, {}
    make_predict, restore = jax_harness.make_yolo_predict, jax_eval_cli._restore_variables

    def cached_predict(model, image_wh, anchors, classes_num, **kw):
        key = (image_wh, classes_num, tuple(sorted(kw.items())))
        if key not in predictors:
            predictors[key] = make_predict(model, image_wh, anchors, classes_num,
                                           nms_backend="xla", **kw)
        return predictors[key]

    def cached_restore(args, model, x0):
        if args.modelPath not in restored:
            restored[args.modelPath] = restore(args, model, x0)
        return restored[args.modelPath]

    return cached_predict, cached_restore


def test_eval_map_step_matches_jax(tiny_set, jax_cli_cache):
    root, flax_model, variables, net = tiny_set
    args = (str(root / "imgs"), str(root / "labels.txt"), str(root / "classes.txt"), 1,
            ANCHORS)
    kw = dict(image_wh=(SIZE, SIZE), image_random=False, label_mean=False, prefetch=0)
    port = iter(YoloDataPipeline(*args, device="cpu", **kw))
    ref = iter(JaxPipeline(*args, **kw))
    kw = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="diou")
    jax_predict = jax_cli_cache[0](flax_model, (SIZE, SIZE), ANCHORS, 3, quant="off", **kw)
    predict = make_yolo_predict(net.eval(), (SIZE, SIZE), ANCHORS, 3, **kw)
    got = [eval_map_step(predict, None, next(port), 3) for _ in range(6)]
    want = [jax_harness.eval_map_step(jax_predict, variables, next(ref), 3) for _ in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 0 < np.mean(got) < 1


@pytest.mark.parametrize("mode", ["batch", "global"])
@pytest.mark.parametrize("variant", ["reference", "voc", "coco"])
def test_eval_cli_matches_jax_cli(tiny_set, jax_cli_cache, monkeypatch, capsys, mode,
                                  variant):
    root = tiny_set[0]
    common = cli_files(root) + ["--mode", mode, "--variant", variant]
    monkeypatch.setattr(jax_harness, "make_yolo_predict", jax_cli_cache[0])
    monkeypatch.setattr(jax_eval_cli, "_restore_variables", jax_cli_cache[1])
    monkeypatch.setattr("sys.argv", ["eval_map"] + common + ["--modelPath",
                                                             str(root / "jax_ckpt")])
    jax_eval_cli.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_map.main(common + ["--modelPath", str(root / "model.pt"), "--device", "cpu",
                                  "--batchSize", "2" if mode == "global" else "1"])
    assert got["images"] == want["images"] == 6
    assert (got["mode"], got["variant"]) == (mode, variant)
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=1e-6)
    assert 0 < got["mAP"] < 1


def test_train_cli_on_cpu_saves_resumes_and_evaluates(tiny_set, tmp_path, capsys):
    root = tiny_set[0]
    ckpt = tmp_path / "ckpt"
    base = ["--trainData", str(root / "labels.txt"), "--trainImagePath", str(root / "imgs"),
            "--valData", str(root / "labels.txt"), "--valImagePath", str(root / "imgs"),
            "--classesFile", str(root / "classes.txt"), "--anchorsFile",
            str(root / "anchors.txt"), "--imageSize", str(SIZE), "--batchSize", "2",
            "--stepsPerEpoch", "1", "--lr", "1e-3", "--modelPath", str(ckpt),
            "--device", "cpu"]
    out = train_yolo.main(base + ["--epochs", "2", "--accumSteps", "2"])
    assert out["step"] == 2 and len(out["val_mAP"]) == 2
    assert all(0 <= m <= 1 for m in out["val_mAP"])
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) == ["1.pt", "2.pt"]
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["raw_loss"]) for r in records)

    again = train_yolo.main(base + ["--epochs", "3"])
    assert again["step"] == 3 and "resumed from step 2" in capsys.readouterr().out
    result = eval_map.main(cli_files(root) + ["--modelPath", str(ckpt), "--device", "cpu"])
    assert result["images"] == 6 and 0 <= result["mAP"] <= 1
    assert "checkpoint at step 3" in capsys.readouterr().out


def test_clis_refuse_unported_flags_and_need_a_card(tiny_set, capsys):
    root = tiny_set[0]
    train = ["--trainData", "l.txt", "--trainImagePath", "i", "--classesFile", "c.txt",
             "--anchorsFile", "a.txt"]
    with pytest.raises(SystemExit):
        train_yolo.parse_args(train + ["--tp", "2"])
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP.md queue 6" in err and "--tp" in err
    # --dp, --fsdp and --sp are ported; the JAX CLI's combination rules hold, and the
    # port splits the image's rows evenly
    assert train_yolo.parse_args(train + ["--dp"]).dp
    assert train_yolo.parse_args(train + ["--fsdp"]).fsdp
    assert train_yolo.parse_args(train + ["--sp", "2"]).sp == 2
    with pytest.raises(SystemExit):
        train_yolo.parse_args(train + ["--sp", "3"])
    assert "--imageSize 416 is not divisible by --sp 3" in capsys.readouterr().err
    for extra, why in ((["--fsdp", "--sp", "2"], "--fsdp shards state over the data axis"),
                       (["--dp", "--fsdp"], "--dp is implied by --sp/--tp/--fsdp"),
                       (["--sp", "2", "--tp", "2"], "--sp and --tp cannot be combined")):
        with pytest.raises(SystemExit):
            train_yolo.parse_args(train + extra)
        assert why in capsys.readouterr().err
    assert train_yolo.parse_args(train).device == "cuda"
    taken = train_yolo.parse_args(train + ["--mosaic", "0.5", "--cacheDir", "c", "--remat"])
    assert (taken.mosaic, taken.cacheDir, taken.remat) == (0.5, "c", True)
    ported = train_yolo.parse_args(train + ["--version", "v3", "--darknetWeights", "x.weights",
                                            "--warmupSteps", "5"])
    assert (ported.version, ported.darknetWeights, ported.warmupSteps) == ("v3", "x.weights", 5)
    for extra in (["--int8Static"], ["--int8Static", "--int8PerChannel"],
                  ["--int8Static", "--int8Margin", "0.5"]):
        got = eval_map.main(cli_files(root) + ["--modelPath", str(root / "model.pt"),
                                               "--device", "cpu", "--maxImages", "2"] + extra)
        assert got["quant"] == "int8_static" and got["images"] == 2 and 0 <= got["mAP"] <= 1
        assert got.get("int8_margin") == (0.5 if "--int8Margin" in extra else None)
        assert "calibrating int8 scales on 16 images" in capsys.readouterr().out
    assert eval_map.parse_args(cli_files(root) + ["--cacheDir", "c"]).cacheDir == "c"
    for version in ("v3", "resnet"):
        assert eval_map.parse_args(cli_files(root) + ["--version", version]).version == version
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_map.main(cli_files(root))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_yolo.main(train)


# ------------------------------------------------------------ EfficientDet-D0
D0_CLASSES = 4                       # 3 names + background


@pytest.fixture(scope="module")
def d0_set(tmp_path_factory):
    """D0 (64 px, 3 classes + background) as a JAX checkpoint and a
    ``.pt``, and 6 PNGs labelled with some of its own detections (jittered)
    plus a box it misses."""
    root = tmp_path_factory.mktemp("d0_eval_set")
    rng = np.random.default_rng(21)
    cfg = efficientdet_config("efficientdet-d0", D0_CLASSES, SIZE)
    flax_model = FlaxEfficientDetNet(config=cfg)
    # the JAX package's own init (a seeded tree's activations grow to ~1e7 through
    # D0 and decode to infinite boxes), with the foreground classes' predict
    # bias raised from the focal prior to +1, so that the raw logits pass 1e-4
    variables = flax_model.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    variables = {k: jax.tree.map(np.array, tree) for k, tree in variables.items()}
    bias = variables["params"]["class_net"]["net"]["predict"]["pointwise"]["bias"]
    bias.reshape(9, D0_CLASSES)[:, 1:] = 1.0
    net, anchors = build_efficientdet("efficientdet-d0", D0_CLASSES, SIZE, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    torch.save(net.state_dict(), root / "model.pt")
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], optax.sgd(1e-3))
    mgr = JaxCheckpointManager(str(root / "jax_ckpt"))
    mgr.save(0, state)
    mgr.close()

    os.makedirs(root / "imgs")
    pixels = (rng.uniform(0, 1, (6, SIZE, SIZE, 3)) * 255).round().astype(np.uint8)
    collect = make_efficientdet_pred_gt(net.eval(), anchors)
    found = collect({"image": torch.from_numpy(pixels.astype(np.float32) / 255.0),
                     "raw": [(np.zeros((0, 4)), np.zeros(0))] * 6})
    lines = []
    for i, (pred, _) in enumerate(found):
        Image.fromarray(pixels[i]).save(root / "imgs" / f"im{i}.png")
        entries = []
        for y1, x1, y2, x2, cid, _score in pred[:4]:
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.uniform(-2, 2, 4), 0, SIZE)
            if x2 - x1 > 2 and y2 - y1 > 2:
                entries.append(f"{NAMES[int(cid) - 1]},{x1:.1f},{y1:.1f},{x2:.1f},{y2:.1f}")
        entries.append(f"{NAMES[i % 3]},5,5,40,44")
        lines.append(f"im{i}.png|{'|'.join(entries)}|")
    assert sum(len(p) for p, _ in found) > 0
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(NAMES) + "\n")
    return root, flax_model, variables, net, anchors


def d0_files(root):
    return ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--imagePath",
            str(root / "imgs"), "--labelFile", str(root / "labels.txt"), "--classesFile",
            str(root / "classes.txt"), "--imageSize", str(SIZE)]


@pytest.fixture(scope="module")
def jax_d0_cache():
    """The JAX CLI's ``make_efficientdet_pred_gt`` and ``_restore_variables``, made
    once per argument set, so that its six runs share one compiled forward."""
    collects, restored = {}, {}
    make, restore = jax_d0_harness.make_efficientdet_pred_gt, jax_eval_cli._restore_variables

    def cached_collect(model, anchors, quant="off"):
        key = (model.config.image_size, model.config.num_classes, quant)
        if key not in collects:
            collects[key] = make(model, anchors, quant=quant)
        return collects[key]

    def cached_restore(args, model, x0):
        if args.modelPath not in restored:
            restored[args.modelPath] = restore(args, model, x0)
        return restored[args.modelPath]

    return cached_collect, cached_restore


def test_d0_pred_gt_rows_match_jax(d0_set, jax_d0_cache, monkeypatch, one_torch_thread):
    root, flax_model, variables, net, anchors = d0_set
    files = (str(root / "imgs"), str(root / "labels.txt"), str(root / "classes.txt"), 3)
    kw = dict(image_size=SIZE, augment=False, label_mean=False, with_raw_boxes=True,
              prefetch=0)
    port = iter(EfficientDetPipeline(*files, anchors, D0_CLASSES, device="cpu", **kw))
    cfg = flax_model.config
    janchors = JaxAnchors(cfg.min_level, cfg.max_level, (SIZE, SIZE), cfg.num_scales,
                          cfg.aspect_ratios, cfg.anchor_scale)
    ref = iter(JaxD0Pipeline(*files, janchors, D0_CLASSES, **kw))
    collect = make_efficientdet_pred_gt(net.eval(), anchors)
    jax_collect = jax_d0_cache[0](flax_model, janchors)
    monkeypatch.setattr(jax_d0_harness, "make_efficientdet_pred_gt", jax_d0_cache[0])
    eval_step = make_efficientdet_eval(net, anchors)
    jax_eval_step = jax_d0_harness.make_efficientdet_eval(flax_model, janchors, None)
    kept = 0
    for _ in range(2):
        batch, jbatch = next(port), next(ref)
        for (gp, gg), (wp, wg) in zip(collect(batch), jax_collect(variables, jbatch)):
            assert gp.shape == wp.shape
            np.testing.assert_array_equal(gp[:, 4], wp[:, 4])        # 1-based class ids
            np.testing.assert_allclose(gp, wp, rtol=1e-5, atol=1e-4)
            np.testing.assert_array_equal(gg, wg)
            kept += len(gp)
        np.testing.assert_allclose(eval_step(batch)["mAP"],
                                   jax_eval_step(variables, jbatch)["mAP"], rtol=1e-6)
    assert kept > 0


@pytest.mark.parametrize("mode", ["batch", "global"])
@pytest.mark.parametrize("variant", ["reference", "voc", "coco"])
def test_d0_eval_cli_matches_jax_cli(d0_set, jax_d0_cache, monkeypatch, capsys, mode, variant,
                                    one_torch_thread):
    root = d0_set[0]
    common = d0_files(root) + ["--mode", mode, "--variant", variant]
    monkeypatch.setattr(jax_d0_harness, "make_efficientdet_pred_gt", jax_d0_cache[0])
    monkeypatch.setattr(jax_eval_cli, "_restore_variables", jax_d0_cache[1])
    monkeypatch.setattr("sys.argv", ["eval_map"] + common + ["--modelPath",
                                                             str(root / "jax_ckpt")])
    jax_eval_cli.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_map.main(common + ["--modelPath", str(root / "model.pt"), "--device", "cpu",
                                  "--batchSize", "4" if mode == "global" else "1"])
    assert got["images"] == want["images"] == 6
    assert (got["family"], got["mode"], got["variant"]) == ("efficientdet", mode, variant)
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=1e-6)
    assert 0 < got["mAP"] < 1


def test_d0_train_cli_on_cpu_saves_resumes_and_evaluates(d0_set, tmp_path, capsys,
                                                         one_torch_thread):
    root = d0_set[0]
    ckpt = tmp_path / "ckpt"
    base = ["--modelName", "efficientdet-d0", "--trainData", str(root / "labels.txt"),
            "--trainImagePath", str(root / "imgs"), "--classesFile", str(root / "classes.txt"),
            "--imageSize", str(SIZE), "--batchSize", "2", "--stepsPerEpoch", "1",
            "--modelPath", str(ckpt), "--device", "cpu"]
    out = train_efficientdet.main(base + ["--epochs", "2", "--accumSteps", "2"])
    assert out == {"step": 2, "epochs": 2}
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) == ["1.pt", "2.pt"]
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["gnorm"] > 0 for r in records)
    saved = torch.load(ckpt / "2.pt", weights_only=True)
    assert saved["ema_params"] is not None and saved["ema_batch_stats"] is None
    assert all("momentum_buffer" in s for s in saved["optimizer"]["state"].values())

    again = train_efficientdet.main(base + ["--epochs", "3", "--deviceAug"])
    assert again["step"] == 3 and "resumed from step 2" in capsys.readouterr().out
    result = eval_map.main(d0_files(root) + ["--modelPath", str(ckpt), "--device", "cpu"])
    assert result["images"] == 6 and 0 <= result["mAP"] <= 1
    assert "checkpoint at step 3" in capsys.readouterr().out


def test_d0_train_cli_refuses_unported_flags_and_needs_a_card(capsys):
    train = ["--trainData", "l.txt", "--trainImagePath", "i", "--classesFile", "c.txt"]
    with pytest.raises(SystemExit):
        train_efficientdet.parse_args(train + ["--tp", "2"])
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP.md queue 6" in err and "--tp" in err
    # --dp, --fsdp and --sp are ported; the JAX CLI's combination rules hold
    assert train_efficientdet.parse_args(train + ["--dp"]).dp
    assert train_efficientdet.parse_args(train + ["--fsdp"]).fsdp
    assert train_efficientdet.parse_args(train + ["--sp", "2", "--imageSize", "512"]).sp == 2
    for extra, why in ((["--fsdp", "--tp", "2"], "--fsdp shards state over the data axis"),
                       (["--dp", "--fsdp"], "--dp is implied by --sp/--tp/--fsdp"),
                       (["--dp", "--sp", "2"], "--dp is implied by --sp/--tp/--fsdp"),
                       (["--sp", "2", "--tp", "2"], "--sp and --tp cannot be combined"),
                       (["--sp", "3", "--imageSize", "512"], "is not divisible by --sp 3")):
        with pytest.raises(SystemExit):
            train_efficientdet.parse_args(train + extra)
        assert why in capsys.readouterr().err
    taken = train_efficientdet.parse_args(train + ["--cacheDir", "c", "--deviceAug", "--remat"])
    assert (taken.cacheDir, taken.remat) == ("c", True)
    args = train_efficientdet.parse_args(train)
    assert (args.device, args.modelName, args.batchSize) == ("cuda", "efficientdet-d1", 8)
    cfg = efficientdet_config("efficientdet-d0", D0_CLASSES, SIZE)
    masks = [torch.zeros(2, 8, 8, 9, 1, dtype=torch.bool),
             torch.zeros(2, 4, 4, 9, 1, dtype=torch.bool)]
    train_efficientdet.warn_zero_foreground({"masks": masks}, cfg)
    assert "ZERO foreground anchors" in capsys.readouterr().out
    masks[1][0, 2, 2, 4] = True
    train_efficientdet.warn_zero_foreground({"masks": masks}, cfg)
    assert capsys.readouterr().out == ""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_efficientdet.main(train)
