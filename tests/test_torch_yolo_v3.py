"""The port's YOLOv3 and ResNetYoloV3 (``tmv_tpu_torch.models.yolo_v3``,
``models.moco``, ``models.backbones.resnet_v2``) against the flax models.

- Both whole models (80 classes is not needed: 2 classes, full width) at 64 and
  96 px on bridged seeded weights whose BatchNorm statistics are not trivial, in
  eval mode in float32: heads within 2e-5·max|ref| (rtol 1e-5), as YOLOv4's
  (measured up to 4.7e-6).
- In train mode in float64 on both sides (JAX under ``jax.enable_x64``: float32
  rounding through batch statistics over 8 values per channel would hide the
  arithmetic): heads within 1e-9·max|ref| and every running mean and variance
  after the step within 1e-7 of its largest entry (as YOLOv4's step test; the
  batch means of the heads' ~1e6-large activations cancel to ~0.3) — flax's
  biased update, also for ResNet's epsilon 1.001e-5.
- The bridge maps both full trees with exactly the model's keys and shapes,
  ResNet's stem ``conv1`` included, and the blocks' shortcut conv is ``Conv_0``.
- ``build_yolo_model('v3'/'resnet')`` returns the JAX package's iou types.
- A batched YOLOv3 predict at 64 px, IoU NMS, equals JAX's per-image predict:
  valid masks, ids (so the NMS index lists) exactly, boxes and scores rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models import detector_harness as jax_harness
from tmv_tpu.models.moco import ResNetYoloV3 as FlaxResNetYoloV3
from tmv_tpu.models.yolo_v3 import YoloV3 as FlaxYoloV3
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_predict_batched
from tmv_tpu_torch.models.moco import ResNetYoloV3
from tmv_tpu_torch.models.yolo_v3 import YoloV3
from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
from torch_port_cases import seeded_variables

MODELS = {
    "v3": (lambda: FlaxYoloV3(classes_num=2), lambda **kw: YoloV3(2, **kw)),
    "resnet": (lambda: FlaxResNetYoloV3(out_filters=21), lambda **kw: ResNetYoloV3(21, **kw)),
}


def bridged(version, size, seed):
    make_flax, make_torch = MODELS[version]
    flax_model = make_flax()
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, size, size, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(seed)))
    net = make_torch()
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    return flax_model, variables, net


@pytest.fixture(scope="module")
def nets():
    return {version: bridged(version, 64, seed) for seed, version in enumerate(MODELS)}


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("version", sorted(MODELS))
def test_heads_match_flax_in_eval_mode(nets, version, size):
    flax_model, variables, net = nets[version]
    images = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = [np.asarray(h) for h in flax_model.apply(variables, jnp.asarray(images))]
    with torch.inference_mode():
        got = [h.numpy() for h in net.eval()(torch.from_numpy(images))]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, size // s, size // s, 21) for s in (32, 16, 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5 * np.abs(w).max())


@pytest.mark.parametrize("version", sorted(MODELS))
def test_train_mode_heads_and_statistics_match_flax_in_float64(nets, version):
    flax_model, variables, _ = nets[version]
    images = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3))
    with jax.enable_x64(True):
        model64 = (FlaxYoloV3(classes_num=2, dtype=jnp.float64) if version == "v3"
                   else FlaxResNetYoloV3(out_filters=21, dtype=jnp.float64))
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, mutated = jax.jit(lambda v, x: model64.apply(
            v, x, train=True, mutable=["batch_stats"]))(cast, jnp.asarray(images))
        want = [np.asarray(h) for h in want]
        stats = flax_to_state_dict({"params": variables["params"],
                                    "batch_stats": jax.tree.map(np.asarray,
                                                                mutated["batch_stats"])})
    net = MODELS[version][1](dtype=torch.float64)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    net = net.to(torch.float64).train()
    with torch.no_grad():
        got = [h.numpy() for h in net(torch.from_numpy(images))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9 * np.abs(w).max())
    state = net.state_dict()
    names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    for key in names:
        w = stats[key].double()
        assert float((state[key] - w).abs().max()) <= 1e-7 * float(w.abs().max()), key


def test_bridge_maps_the_full_trees(nets):
    for version, (_, variables, net) in nets.items():
        state = flax_to_state_dict(variables, net)      # exact keys and shapes, or raises
        assert set(state) == set(net.state_dict())
    resnet = nets["resnet"][2].state_dict()
    assert resnet["ResNet50V2_0.conv1.weight"].shape == (64, 3, 7, 7)
    assert resnet["ResNet50V2_0.conv1.bias"].shape == (64,)
    # block1 of each stack runs its shortcut conv first: Conv_0 is the 1x1 to 4·filters
    assert resnet["ResNet50V2_0.conv2.block1.Conv_0.weight"].shape == (256, 64, 1, 1)
    assert resnet["ResNet50V2_0.conv2.block1.Conv_3.weight"].shape == (256, 64, 1, 1)
    assert resnet["ResNet50V2_0.conv2.block2.Conv_2.weight"].shape == (256, 64, 1, 1)
    assert "ResNet50V2_0.conv2.block2.Conv_3.weight" not in resnet
    assert nets["resnet"][2].ResNet50V2_0.conv2.block1.BatchNorm_0.eps == 1.001e-5
    v3 = nets["v3"][2].state_dict()
    assert v3["DarknetBody_0.ResblockBody_2.ConvBN_16.DarknetConv_0.Conv_0.weight"].shape == (
        256, 128, 3, 3)


def test_build_yolo_model_iou_types():
    for version in ("v3", "resnet", "v4"):
        model, iou_type = build_yolo_model(version, 2, device="cpu")
        assert iou_type == jax_harness.build_yolo_model(version, 2)[1]
        assert sum(p.numel() for p in model.parameters()) > 2e7
    assert isinstance(build_yolo_model("resnet", 2, device="cpu")[0], ResNetYoloV3)
    with pytest.raises(ValueError, match="unknown"):
        build_yolo_model("v5", 2, device="cpu")


def test_batched_v3_predict_matches_jax(nets):
    """Box channels scaled by 1e-6 so that the boxes are finite, valid and of
    image size while the objectness and class logits stay saturated (scores tie
    at 1.0)."""
    flax_model, variables, _ = nets["v3"]
    variables = jax.tree.map(np.array, variables)
    for name in ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2"):
        kernel = variables["params"][name]["Conv_0"]["kernel"]
        kernel[..., np.arange(kernel.shape[-1]) % 7 < 4] *= 1e-6
    net = YoloV3(2)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    images = np.random.default_rng(9).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    kw = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="iou")
    jax_predict = jax_harness.make_yolo_predict(flax_model, (64, 64), COCO_ANCHORS, 2,
                                                nms_backend="xla", **kw)
    got = make_yolo_predict_batched(net.eval(), (64, 64), COCO_ANCHORS, 2, **kw)(None, images)
    for i in range(3):
        want = [np.asarray(o) for o in jax_predict(variables, jnp.asarray(images[i:i + 1]))]
        g_boxes, g_ids, g_scores, g_valid = (o[i] for o in got)
        w_boxes, w_ids, w_scores, w_valid = want
        np.testing.assert_array_equal(g_valid, w_valid)
        assert w_valid.sum() > 5 and np.abs(w_boxes[w_valid]).max() < 10
        np.testing.assert_array_equal(g_ids[g_valid], w_ids[w_valid])
        np.testing.assert_allclose(g_boxes[g_valid], w_boxes[w_valid], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g_scores[g_valid], w_scores[w_valid], rtol=1e-5, atol=1e-5)
