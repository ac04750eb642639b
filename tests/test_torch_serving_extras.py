"""The port's WSGI entry (``serving/wsgi.py``) and one-image CLI (``cli/detect.py``).

- The WSGI module built from the ``TMV_*`` environment with ``TMV_DEVICE=cpu``
  on a checkpoint directory (``core/checkpoint.py``, as the trainers write it)
  of a seeded YOLOv4 and of a seeded EfficientDet-D0 answers one request as
  ``cli/serve.py::build_app`` on the same directory does (the same JSON); the
  module defines no application without ``TMV_CLASSES_FILE``.
- ``cli/detect.py --device cpu`` writes its image with the boxes drawn for both
  families (v4 and v3 for YOLO); its detections equal the port's predictor's
  (``make_yolo_predict`` / ``make_efficientdet_predict`` behind a
  ``DetectionService``) on the same weights and thresholds, and are not empty.
The seeded YOLO weights have their output convs' box rows scaled by 1e-3 and
D0 its foreground class bias raised to +1, so that random weights detect boxes.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu_torch.cli import detect, serve
from tmv_tpu_torch.core.checkpoint import CheckpointManager, load_weights
from tmv_tpu_torch.core.train_state import TrainState
from tmv_tpu_torch.data.loaders import load_anchors
from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_predict
from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet, make_efficientdet_predict
from tmv_tpu_torch.serving.app import DetectionService
from tmv_tpu_torch.utils import image_helper
from torch_port_cases import (  # noqa: F401 (fixtures)
    answer_one_request, disposable_tmp, one_torch_thread, write_yolo_inputs,
)

SIZE = 64


def seeded(family, version="v4"):
    """A seeded model of the family whose random weights detect boxes."""
    if family == "efficientdet":
        from tmv_tpu_torch.models.efficientdet.net import init_weights

        model, _ = build_efficientdet("efficientdet-d0", 4, SIZE, device="cpu")
        init_weights(model, 0)
        with torch.no_grad():
            model.class_net.net.predict.pointwise.bias[1:] = 1.0
        return model
    from tmv_tpu_torch.models.layers.common import init_weights

    model, _ = build_yolo_model(version, 3, device="cpu")
    init_weights(model, 0)
    with torch.no_grad():
        for k in range(3):
            weight = getattr(model, f"DarknetConv_{k}").Conv_0.weight
            weight[torch.arange(weight.shape[0]) % 8 < 4] *= 1e-3
    return model


def checkpoint_dir(model, path):
    """A weights-only checkpoint directory at step 7, as ``core/checkpoint.py``
    writes it."""
    mgr = CheckpointManager(str(path))
    mgr.save(7, TrainState(model, None, step=7))
    mgr.close()
    return str(path)


def jpeg(path, seed=3):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (56, 72, 3), dtype=np.uint8)).save(path)
    return str(path)


@pytest.mark.parametrize("family", ["yolo", "efficientdet"])
def test_wsgi_module_answers_as_build_app(disposable_tmp, monkeypatch, capsys, family,
                                          one_torch_thread):
    files = write_yolo_inputs(disposable_tmp)
    ckpt = checkpoint_dir(seeded(family), disposable_tmp / "ckpt")
    cli = ["--modelPath", ckpt, "--classesFile", files[1], "--imageSize", str(SIZE),
           "--device", "cpu"]
    env = {"TMV_MODEL_PATH": ckpt, "TMV_CLASSES_FILE": files[1], "TMV_IMAGE_SIZE": str(SIZE),
           "TMV_BF16": "0", "TMV_DEVICE": "cpu"}
    if family == "yolo":
        cli += ["--anchorsFile", files[3]]
        env["TMV_ANCHORS_FILE"] = files[3]
    else:
        cli += ["--family", "efficientdet", "--modelName", "efficientdet-d0"]
        env.update(TMV_FAMILY="efficientdet", TMV_MODEL_NAME="efficientdet-d0")
    monkeypatch.delenv("TMV_CLASSES_FILE", raising=False)
    monkeypatch.delitem(sys.modules, "tmv_tpu_torch.serving.wsgi", raising=False)
    assert not hasattr(importlib.import_module("tmv_tpu_torch.serving.wsgi"), "application")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delitem(sys.modules, "tmv_tpu_torch.serving.wsgi")
    wsgi = importlib.import_module("tmv_tpu_torch.serving.wsgi")
    assert "checkpoint at step 7" in capsys.readouterr().out
    app, _, _ = serve.build_app(serve.parse_args(cli))
    got, want = answer_one_request(wsgi.application), answer_one_request(app)
    assert got[0].startswith("200") and got == want
    assert len(got[1]["boxes"]) > 0
    monkeypatch.setenv("TMV_DEVICE", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wsgi.build_application()


@pytest.mark.parametrize("family, version", [("yolo", "v4"), ("yolo", "v3"),
                                             ("efficientdet", "d0")])
def test_detect_cli_writes_the_predictors_detections(disposable_tmp, capsys, family, version,
                                                     one_torch_thread):
    files = write_yolo_inputs(disposable_tmp)
    model = seeded(family, version)
    ckpt = checkpoint_dir(model, disposable_tmp / "ckpt")
    image = jpeg(disposable_tmp / "in.jpg")
    out = str(disposable_tmp / "out.jpg")
    args = ["--image", image, "--out", out, "--modelPath", ckpt, "--classesFile", files[1],
            "--imageSize", str(SIZE), "--device", "cpu", "--scoresThresh", "0.3"]
    if family == "yolo":
        args += ["--anchorsFile", files[3], "--version", version]
    else:
        args += ["--family", "efficientdet"]
    boxes, ids, scores = detect.main(args)
    assert os.path.exists(out) and "wrote" in capsys.readouterr().out
    assert Image.open(out).size == (72, 56)

    # the predictor itself on a fresh load of the directory, same thresholds
    names = [f"class_{i}" for i in range(3)]
    if family == "yolo":
        fresh, iou_type = build_yolo_model(version, 3, device="cpu")
        anchors = load_anchors(files[3])
        load_weights(fresh, ckpt)
        predict = make_yolo_predict(fresh.eval(), (SIZE, SIZE), anchors, 3,
                                    confidence_thresh=0.5, scores_thresh=0.3, iou_thresh=0.5,
                                    iou_type=iou_type)
    else:
        fresh, anchors = build_efficientdet("efficientdet-d0", 4, SIZE, device="cpu")
        load_weights(fresh, ckpt)
        predict = make_efficientdet_predict(fresh.eval(), anchors, SIZE, iou_threshold=0.5,
                                            score_threshold=0.3)
    with open(image, "rb") as f:
        img = image_helper.bytes_to_image(f.read())
    want = DetectionService(predict, None, names, (SIZE, SIZE)).predict_image(img)[:3]
    assert len(boxes) > 0
    np.testing.assert_array_equal(boxes, want[0])
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_allclose(scores, want[2], rtol=1e-6)
    with pytest.raises(SystemExit):
        detect.parse_args(["--image", image, "--modelPath", ckpt, "--classesFile", files[1]])
    assert detect.parse_args(["--image", image, "--modelPath", ckpt, "--classesFile",
                              files[1], "--family", "efficientdet"]).device == "cuda"
