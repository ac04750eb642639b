"""``serve --spatial`` and its predictors on the CPU.

- The height-sharded predictor (``parallel.inference.make_spatial_predictor`` over
  ``[cpu] x S``) against the unsharded port predictor on the same module and image:
  YOLOv4 @64 (full width, seeded, every candidate kept: thresholds 0) over 2 shards and
  EfficientDet-D0 @64 over 4; the NMS index lists (``valid`` and the class ids)
  exactly equal, scores within 1e-4 and boxes within 1e-4 + 1e-3 of their size (the
  heads differ by the order of sums, ~1e-6 of their size; a seeded YOLOv4's boxes are
  exponentials of heads near 75).
- The static int8 path (per-channel, calibrated on four images) and the dynamic one
  height-sharded: the heads within 2e-2·max|ref| of the unsharded int8 forward's (a
  rounding flip of a quantized value moves a head by one int8 step, and the dynamic
  absmax is the whole image's, ``halo.space_max``); with every other shard's rows
  zeroed the same forward leaves that tolerance.
- ``serve --spatial 2 --device cpu`` answers the reference contract.
"""

import numpy as np
import pytest
import torch

import torch_spatial_cases as sc
from tmv_tpu_torch.cli import serve
from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_predict_batched
from tmv_tpu_torch.models.efficientdet.harness import (
    build_efficientdet, make_efficientdet_predict_batched,
)
from tmv_tpu_torch.models.efficientdet.net import init_weights as d0_init
from tmv_tpu_torch.models.layers.common import init_weights
from tmv_tpu_torch.parallel import halo
from tmv_tpu_torch.parallel.inference import make_spatial_predictor
from tmv_tpu_torch.quant.dynamic import quantized
from tmv_tpu_torch.quant.static import calibrate_model, prepare_static_int8
from torch_port_cases import (  # noqa: F401 (a fixture)
    answer_one_request, one_torch_thread, write_yolo_inputs,
)

SIZE = 64


def assert_same_detections(want, got):
    boxes, ids, scores, valid = want
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[1][valid], ids[valid])
    np.testing.assert_allclose(got[0][valid], boxes[valid], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2][valid], scores[valid], rtol=1e-4, atol=1e-4)


def image(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)


def test_yolo_spatial_predictor_equals_the_unsharded(one_torch_thread):
    model, iou_type = build_yolo_model("v4", 3, device="cpu")
    init_weights(model, 0).eval()
    anchors = sc.cases.COCO_ANCHORS * SIZE / 416

    def batched(module):
        return make_yolo_predict_batched(module, (SIZE, SIZE), anchors, 3, confidence_thresh=0.0,
                                         scores_thresh=0.0, iou_type=iou_type,
                                         max_output_size=50)

    sharded, _, devices = make_spatial_predictor(model, batched, 2, device="cpu")
    try:
        assert_same_detections(batched(model)(None, image()), sharded(None, image()))
    finally:
        sharded.close()
    assert [str(d) for d in devices] == ["cpu", "cpu"]


def test_d0_spatial_predictor_equals_the_unsharded(one_torch_thread):
    model, anchors = build_efficientdet("efficientdet-d0", 3, SIZE, device="cpu")
    d0_init(model, 0).eval()
    with torch.no_grad():     # foreground logits spread, so that boxes pass the threshold
        model.class_net.net.predict.pointwise.bias.uniform_(
            0.5, 1.5, generator=torch.Generator().manual_seed(0))

    def batched(module):
        return make_efficientdet_predict_batched(module, anchors, SIZE, max_output_size=50)

    sharded, _, _ = make_spatial_predictor(model, batched, 4, device="cpu")
    try:
        assert_same_detections(batched(model)(None, image(1)), sharded(None, image(1)))
    finally:
        sharded.close()


@pytest.mark.parametrize("mode", ["int8_static", "int8"])
def test_int8_forward_height_sharded(mode, monkeypatch):
    model = sc.narrow_v4()
    init_weights(model, 0).eval()
    x = torch.from_numpy(image(2))
    if mode == "int8_static":
        stats = calibrate_model(model, [torch.from_numpy(image(i)) for i in range(3, 7)])
        prepare_static_int8(model, stats, per_channel=True)
    with torch.no_grad(), quantized(mode):
        want = model(x)
        got = sc.spatial_forward(model, x, 2)

    def close(outs):
        return all(float((g - w).abs().max()) <= 2e-2 * float(w.abs().max())
                   for g, w in zip(outs, want))

    assert close(got)
    gather = halo.ThreadTransport.all_gather
    monkeypatch.setattr(halo.ThreadTransport, "all_gather", lambda self, t: [
        p if j == self.rank else torch.zeros_like(p) for j, p in enumerate(gather(self, t))])
    with torch.no_grad(), quantized(mode):
        assert not close(sc.spatial_forward(model, x, 2))


def test_serve_spatial_answers_the_reference_contract(tmp_path, capsys):
    args = serve.parse_args(write_yolo_inputs(tmp_path) + [
        "--randomInit", "--imageSize", str(SIZE), "--device", "cpu", "--spatial", "2"])
    app, service, _ = serve.build_app(args)
    status, out = answer_one_request(app)
    assert status.startswith("200") and set(out) == {"boxes", "classes", "random_img",
                                                     "result_img"}
    assert "spatial serving over 2 devices (cpu, cpu)" in capsys.readouterr().out
