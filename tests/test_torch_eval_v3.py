"""``cli/eval_map.py --version v3`` and ``--version resnet`` of the port against
the JAX eval CLI, on the CPU at 64 × 64.

Each model (3 classes, full width) is seeded, its output convs' box rows scaled
so that the boxes are finite and of image size (by the power of ten that brings
the largest box logit of a seeded image to at most 1), saved as a JAX orbax
checkpoint and as the bridged ``.pt``; 6 PNGs are labelled with some of its own
detections (jittered) and a box it misses, so that the mAP is neither 0 nor 1.
Both CLIs score the set in ``--mode batch`` and ``global`` (reference AP,
IoU NMS at the JAX CLI's thresholds): the same mAP (rtol 1e-6), strictly
between 0 and 1. The JAX predictor and restore are made once per model.
"""

import json
import os
import shutil

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
from tmv_tpu.models.moco import ResNetYoloV3 as FlaxResNetYoloV3
from tmv_tpu.models.yolo_v3 import YoloV3 as FlaxYoloV3
from tmv_tpu_torch.cli import eval_map
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_predict_batched
from torch_port_cases import seeded_variables

SIZE = 64
NAMES = ["red", "green", "blue"]
ANCHORS = np.array([[[24, 24], [28, 28], [32, 32]], [[12, 12], [16, 16], [20, 20]],
                    [[6, 6], [8, 8], [10, 10]]])
FLAX = {"v3": lambda: FlaxYoloV3(classes_num=3),
        "resnet": lambda: FlaxResNetYoloV3(out_filters=24)}


def _scaled_box_rows(variables, net, images):
    """Scale the output convs' box rows of ``variables`` (and load them into
    ``net``) so that the largest box logit on ``images`` is at most 1."""
    with torch.inference_mode():
        heads = net.eval()(torch.from_numpy(images))
    box_max = max(float(h.reshape(*h.shape[:3], 3, 8)[..., :4].abs().max()) for h in heads)
    factor = 10.0 ** -np.ceil(np.log10(box_max))
    for name in ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2"):
        kernel = variables["params"][name]["Conv_0"]["kernel"]
        kernel[..., np.arange(kernel.shape[-1]) % 8 < 4] *= factor
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)


@pytest.fixture(scope="module", params=sorted(FLAX))
def labelled(request, tmp_path_factory):
    version = request.param
    root = tmp_path_factory.mktemp(f"eval_{version}")
    rng = np.random.default_rng(31)
    flax_model = FLAX[version]()
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree.map(np.array, seeded_variables(shapes, rng))
    net, _ = build_yolo_model(version, 3, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    pixels = (rng.uniform(0, 1, (6, SIZE, SIZE, 3)) * 255).round().astype(np.uint8)
    images = pixels.astype(np.float32) / 255.0
    _scaled_box_rows(variables, net, images)
    torch.save(net.state_dict(), root / "model.pt")
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], optax.sgd(1e-3))
    mgr = JaxCheckpointManager(str(root / "jax_ckpt"))
    mgr.save(0, state)
    mgr.close()

    os.makedirs(root / "imgs")
    predict = make_yolo_predict_batched(net.eval(), (SIZE, SIZE), ANCHORS, 3,
                                        confidence_thresh=0.5, scores_thresh=0.2,
                                        iou_type="iou")
    boxes, ids, _, valid = predict(None, images)
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
    assert sum(line.count(",") for line in lines) > 6 * 4
    (root / "labels.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("\n".join(NAMES) + "\n")
    (root / "anchors.txt").write_text(", ".join(f"{w},{h}" for w, h in
                                                ANCHORS[::-1].reshape(-1, 2)) + "\n")
    yield version, root, {}
    shutil.rmtree(root, ignore_errors=True)     # two ~250 MB checkpoints


def cli_files(root, version):
    return ["--version", version, "--imagePath", str(root / "imgs"), "--labelFile",
            str(root / "labels.txt"), "--classesFile", str(root / "classes.txt"),
            "--anchorsFile", str(root / "anchors.txt"), "--imageSize", str(SIZE)]


@pytest.mark.parametrize("mode", ["batch", "global"])
def test_eval_cli_matches_jax_cli(labelled, monkeypatch, capsys, mode):
    version, root, cache = labelled
    make_predict, restore = jax_harness.make_yolo_predict, jax_eval_cli._restore_variables

    def cached_predict(model, image_wh, anchors, classes_num, **kw):
        if "predict" not in cache:
            cache["predict"] = make_predict(model, image_wh, anchors, classes_num,
                                            nms_backend="xla", **kw)
        return cache["predict"]

    def cached_restore(args, model, x0):
        if "variables" not in cache:
            cache["variables"] = restore(args, model, x0)
        return cache["variables"]

    monkeypatch.setattr(jax_harness, "make_yolo_predict", cached_predict)
    monkeypatch.setattr(jax_eval_cli, "_restore_variables", cached_restore)
    common = cli_files(root, version) + ["--mode", mode]
    monkeypatch.setattr("sys.argv", ["eval_map"] + common + ["--modelPath",
                                                             str(root / "jax_ckpt")])
    jax_eval_cli.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_map.main(common + ["--modelPath", str(root / "model.pt"), "--device", "cpu",
                                  "--batchSize", "3" if mode == "global" else "1"])
    assert got["images"] == want["images"] == 6
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=1e-6)
    assert 0 < got["mAP"] < 1
