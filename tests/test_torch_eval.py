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
  which raises without a card.
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
from tmv_tpu.cli import eval_map as jax_eval_cli
from tmv_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.data.yolo_pipeline import YoloDataPipeline as JaxPipeline
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu_torch.cli import eval_map, train_yolo
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline
from tmv_tpu_torch.models.detector_harness import (
    eval_map_step, make_yolo_predict, make_yolo_predict_batched,
)
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from torch_port_cases import seeded_variables

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
    for extra in (["--version", "v3"], ["--darknetWeights", "x.weights"], ["--mosaic", "0.5"],
                  ["--cacheDir", "c"], ["--remat"], ["--dp"], ["--sp", "2"], ["--tp", "2"],
                  ["--fsdp"]):
        with pytest.raises(SystemExit):
            train_yolo.parse_args(train + extra)
        err = capsys.readouterr().err
        assert "not yet ported" in err and "ROADMAP" in err and extra[0] in err
    assert train_yolo.parse_args(train).device == "cuda"
    for extra in (["--family", "efficientdet"], ["--version", "v3"], ["--cacheDir", "c"],
                  ["--int8Static"], ["--int8PerChannel"], ["--int8Margin", "0.5"]):
        with pytest.raises(SystemExit):
            eval_map.parse_args(cli_files(root) + extra)
        assert "not yet ported" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_map.main(cli_files(root))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_yolo.main(train)
