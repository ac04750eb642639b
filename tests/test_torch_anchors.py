"""The port's EfficientDet anchors and predict-side decode against the JAX package.

- Anchor boxes and feature sizes equal JAX's exactly (D0 @512 and an odd size).
- ``convert_outputs_boxes`` equals JAX's decode to 1e-6·max|ref| per level
  (``exp`` differs by an ulp between XLA and torch, and a coordinate where the
  centre and the half size nearly cancel has no useful relative bound).
- The port's ``convert_outputs_one`` (a leading image axis in place of JAX's
  ``batch_index``: one NMS launch per batch) on JAX's own decoded boxes and
  class logits gives, for every image of a batch and for each image alone,
  exactly JAX's ids, valid mask and selected boxes, and the scores to 1e-6, with
  tied logits, background winners and candidates under the raw-logit threshold.
- The whole batched D0 predictor on seeded images gives the JAX predictor's kept
  set in float32: valid masks and ids exactly, boxes and scores to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.efficientdet.harness import make_efficientdet_predict as jax_predict
from tmv_tpu.ops.anchors import Anchors as JaxAnchors
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.efficientdet.harness import (
    build_efficientdet, efficientdet_config, make_efficientdet_predict_batched,
)
from tmv_tpu_torch.ops.anchors import Anchors, get_feat_sizes
from torch_port_cases import seeded_variables

D0_ANCHORS = dict(min_level=3, max_level=7, num_scales=3,
                  aspect_ratios=[(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)], anchor_scale=4.0)


def both_anchors(size):
    kw = dict(D0_ANCHORS, image_size=(size, size))
    return Anchors(**kw), JaxAnchors(**kw)


@pytest.mark.parametrize("size", [512, 80])
def test_anchor_boxes_equal_jax(size):
    from tmv_tpu.ops.anchors import get_feat_sizes as jax_feat_sizes

    port, ref = both_anchors(size)
    assert get_feat_sizes((size, size), 7) == jax_feat_sizes((size, size), 7)
    assert len(port.boxes) == len(ref.boxes) == 5
    for got, want in zip(port.boxes, ref.boxes):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert port.get_anchors_per_location() == 9


def heads(rng, anchors, batch, classes=6, tied=True):
    """Seeded per-level box regressions and class logits: logits on a 1/4 grid
    (ties), about a third of the anchors' argmax on the background class."""
    boxes, logits = [], []
    for h, w in anchors.feat_sizes[3:8]:
        boxes.append(rng.normal(0, 0.3, (batch, h, w, 9, 4)).astype(np.float32))
        z = rng.normal(0, 1.0, (batch, h, w, 9, classes))
        z[..., 0] += rng.uniform(size=(batch, h, w, 9)) < 0.33
        logits.append((np.round(z * 4) / 4 if tied else z).astype(np.float32))
    return boxes, logits


def test_decode_matches_jax(rng):
    port, ref = both_anchors(80)
    rel, _ = heads(rng, port, 2)
    want = ref.convert_outputs_boxes(tuple(jnp.asarray(r) for r in rel))
    got = port.convert_outputs_boxes([torch.from_numpy(r) for r in rel])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_convert_outputs_one_equals_jax_on_its_heads(rng, tied):
    port, ref = both_anchors(128)
    rel, logits = heads(rng, port, 3, tied=tied)
    decoded = [np.array(d) for d in ref.convert_outputs_boxes(tuple(map(jnp.asarray, rel)))]
    batched = port.convert_outputs_one([torch.from_numpy(d) for d in decoded],
                                       [torch.from_numpy(z) for z in logits])
    assert batched[0].shape == (3, 200, 4) and batched[3].shape == (3, 200)
    for b in range(3):
        want = [np.asarray(o) for o in ref.convert_outputs_one(
            b, tuple(map(jnp.asarray, decoded)), tuple(map(jnp.asarray, logits)),
            nms_backend="xla")]
        alone = port.convert_outputs_one([torch.from_numpy(d[b:b + 1]) for d in decoded],
                                         [torch.from_numpy(z[b:b + 1]) for z in logits])
        for got in ([o[0].numpy() for o in alone], [o[b].numpy() for o in batched]):
            g_boxes, g_ids, g_scores, g_valid = got
            w_boxes, w_ids, w_scores, w_valid = want
            np.testing.assert_array_equal(g_valid, w_valid)
            assert w_valid.sum() > 20
            np.testing.assert_array_equal(g_ids, w_ids)
            np.testing.assert_array_equal(g_boxes, w_boxes)
            np.testing.assert_allclose(g_scores, w_scores, rtol=1e-6, atol=1e-6)
            assert g_ids.dtype == np.int32
            assert (g_ids[g_valid] != 0).all()       # no background survives


@pytest.fixture(scope="module")
def d0_pair():
    """A flax D0 (81 classes) at 64 with seeded weights, and the port's D0 with
    the same weights. The predict convs are scaled so that the logits stay in a
    range where the 1e-4 raw-logit threshold keeps some candidates and not all,
    and the box regressions stay finite."""
    size = 64
    cfg = efficientdet_config("efficientdet-d0", 81, size)
    cfg.fused_dw_eval = False
    flax_model = FlaxEfficientDetNet(config=cfg)
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(5)))
    for head, factor in (("class_net", 1e-6), ("box_net", 1e-7)):
        variables["params"][head]["net"]["predict"]["pointwise"]["kernel"] *= factor
    net, anchors = build_efficientdet("efficientdet-d0", 81, size, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    ref_anchors = JaxAnchors(cfg.min_level, cfg.max_level, (size, size), cfg.num_scales,
                             cfg.aspect_ratios, cfg.anchor_scale)
    return flax_model, variables, ref_anchors, net.eval(), anchors, size


def test_batched_predict_matches_jax(d0_pair):
    flax_model, variables, ref_anchors, net, anchors, size = d0_pair
    images = np.random.default_rng(6).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    predict = jax_predict(flax_model, ref_anchors, size, nms_backend="xla")
    got = make_efficientdet_predict_batched(net, anchors, size)(None, images)
    assert all(isinstance(g, np.ndarray) for g in got)
    assert got[0].shape == (2, 200, 4) and got[3].shape == (2, 200)
    for i in range(len(images)):
        want = [np.asarray(o) for o in predict(variables, jnp.asarray(images[i:i + 1]))]
        g_boxes, g_ids, g_scores, g_valid = (g[i] for g in got)
        w_boxes, w_ids, w_scores, w_valid = want
        np.testing.assert_array_equal(g_valid, w_valid)
        assert 5 < w_valid.sum() < 200
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_allclose(g_boxes[g_valid], w_boxes[w_valid], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g_scores[g_valid], w_scores[w_valid], rtol=1e-5, atol=1e-5)
