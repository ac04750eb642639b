"""Whole models and predictors on the port's int8 paths against ``tmv_tpu`` on the CPU.

- YOLOv4 (full width, 2 classes, 32 × 32) under ``int8_static`` (per-tensor and
  per-channel; JAX's ``quant`` collection carried over by ``quant_from_flax``) and
  under dynamic ``int8``. Every one of the 107 ConvBN sites, fed the input its flax
  twin saw in JAX's int8 forward, gives flax's output within 1e-6·max|JAX| (the
  int8 conv is exact; mish and leaky differ by float32 ulps; measured 2.3e-7).
  Run freely, the two forwards part: an ulp of difference in an activation flips
  one ``xq`` by ±1 now and then (a few per layer at these sizes), and the seeded
  network amplifies each flip, so the heads differ by as much as int8 and float do
  (measured at 64 px: relative L2 0.056-0.089 per-tensor, 0.016-0.029 per-channel,
  0.058-0.093 dynamic; float against JAX's int8: 0.046-0.075). The free-running
  heads are held to relative L2 ≤ 0.25, which catches a wrong fold, pad or scale
  (each gives ≥ 1), not a flip.
- The port's own calibration and prepare on the same model give heads within that
  bound too.
- EfficientDet-D0 (64 px, 3 classes + background, per-channel)
  ``make_efficientdet_pred_gt(..., quant="int8_static")`` against JAX's on the same
  collection, each of the port's int8 sites (the stem, expand, depthwise and project
  convs, and the BiFPN and head SeparableConvs at every level) fed the input its
  JAX twin saw: every site's output within 1e-6·max|JAX|, and the same kept boxes
  (boxes within 1e-3 px, scores within 1e-4, the same classes; the box
  predict kernel is zeroed, so that boxes decode from its bias near the anchors).
- The batched ``int8_static`` predictor equals the single-image one per image
  (YOLOv3 at 64, ``TestQuantBatchedPredictor``), and the dynamic predictor keeps
  finite boxes.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmv_tpu.models.efficientdet.harness as jax_d0_harness
import tmv_tpu.quant.static as jax_static
from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu.ops.anchors import Anchors as JaxAnchors
from tmv_tpu.quant import calibrate_model as jax_calibrate
from tmv_tpu.quant import prepare_static_int8_variables
from tmv_tpu.quant import quantized as jax_quantized
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict, quant_from_flax
from tmv_tpu_torch.models.efficientdet import backbone as d0_backbone
from tmv_tpu_torch.models.efficientdet import bifpn as d0_bifpn
from tmv_tpu_torch.models.detector_harness import (
    build_yolo_model, make_yolo_predict, make_yolo_predict_batched,
)
from tmv_tpu_torch.models.efficientdet.harness import (
    build_efficientdet, efficientdet_config, make_efficientdet_pred_gt,
)
from tmv_tpu_torch.models.layers.common import ConvBN, init_weights
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from tmv_tpu_torch.quant import calibrate_model, prepare_static_int8, quantized
from torch_port_cases import one_torch_thread, seeded_variables  # noqa: F401

SIZE = 64


def seeded(flax_module, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.key(0), *inputs, **kw))
    return jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(seed)))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def bridged(module, variables):
    plain = {k: variables[k] for k in ("params", "batch_stats")}
    module.load_state_dict(flax_to_state_dict(plain, module), strict=True)
    return module.eval()


def assert_heads_near(got, want):
    """Free-running heads: finite, the same shapes, relative L2 ≤ 0.25 each."""
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 0.25, rel


@pytest.fixture(scope="module")
def yolo_pair():
    flax_model = FlaxYoloV4(classes_num=2)
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = seeded(flax_model, jnp.asarray(images[:1]), train=False, seed=7)
    stats = jax_calibrate(flax_model, variables, [jnp.asarray(images)], train=False)
    return flax_model, variables, stats, images


def flax_convbn_calls(flax_model, variables, images, quant):
    """JAX's int8 forward → (heads, {ConvBN path: (its input, its output)})."""
    seen = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, FlaxConvBN) and context.method_name == "__call__":
            seen[".".join(context.module.path)] = (np.asarray(args[0]), np.asarray(out))
        return out

    with jax_quantized(quant), flax_nn.intercept_methods(record):
        heads = flax_model.apply(variables, jnp.asarray(images), train=False)
    return heads, seen


def forced_sites(model, seen, images, quant):
    """The port's forward with each ConvBN fed its flax twin's input → {path: output}."""
    names = {m: n for n, m in model.named_modules() if isinstance(m, ConvBN)}
    out = {}
    hooks = [m.register_forward_pre_hook(lambda m, inp: (nchw(seen[names[m]][0]),))
             for m in names]
    hooks += [m.register_forward_hook(
        lambda m, inp, y: out.__setitem__(names[m], y.permute(0, 2, 3, 1).numpy()))
        for m in names]
    try:
        with quantized(quant), torch.no_grad():
            model(torch.from_numpy(images))
    finally:
        for h in hooks:
            h.remove()
    return out


@pytest.mark.parametrize("mode", ["per_tensor", "per_channel", "dynamic"])
def test_yolov4_int8_matches_jax(yolo_pair, one_torch_thread, mode):
    flax_model, variables, stats, images = yolo_pair
    model = bridged(YoloV4(2), variables)
    quant = "int8" if mode == "dynamic" else "int8_static"
    if quant == "int8_static":
        variables = prepare_static_int8_variables(variables, stats,
                                                  per_channel=mode == "per_channel")
        quant_from_flax(variables, model)
    want, seen = flax_convbn_calls(flax_model, variables, images, quant)
    got = forced_sites(model, seen, images, quant)
    assert len(got) == len(seen) == 107
    for path, (_, flax_out) in seen.items():
        np.testing.assert_allclose(got[path], flax_out, rtol=0,
                                   atol=1e-6 * np.abs(flax_out).max(), err_msg=path)
    with quantized(quant), torch.no_grad():
        assert_heads_near(model(torch.from_numpy(images)), want)
    if mode == "per_channel":     # the port's own calibration and prepare
        own = bridged(YoloV4(2), variables)
        prepare_static_int8(own, calibrate_model(own, [images]), per_channel=True)
        with quantized(quant), torch.no_grad():
            assert_heads_near(own(torch.from_numpy(images)), want)


def test_d0_int8_pred_gt_matches_jax(one_torch_thread, monkeypatch):
    cfg = efficientdet_config("efficientdet-d0", 4, SIZE)
    cfg.fused_dw_eval = False
    flax_model = FlaxEfficientDetNet(config=cfg)
    rng = np.random.default_rng(11)
    images = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = seeded(flax_model, jnp.asarray(images[:1]), train=False, seed=11)
    # foreground biases that pass the score threshold, so that boxes are kept
    params = variables["params"]
    bias = params["class_net"]["net"]["predict"]["pointwise"]["bias"].reshape(9, 4).copy()
    bias[:, 1:] = rng.uniform(0.5, 1.5, (9, 3))
    params["class_net"]["net"]["predict"]["pointwise"]["bias"] = bias.reshape(-1)
    # box offsets from the bias alone: the seeded head's input reaches ~1e6 and its
    # offsets decode to infinite boxes
    box = params["box_net"]["net"]["predict"]["pointwise"]
    box["kernel"] = np.zeros_like(box["kernel"])
    qv = prepare_static_int8_variables(
        variables, jax_calibrate(flax_model, variables, [jnp.asarray(images)], train=False),
        per_channel=True)
    anchors = JaxAnchors(cfg.min_level, cfg.max_level, (SIZE, SIZE), cfg.num_scales,
                         cfg.aspect_ratios, cfg.anchor_scale)
    raw = [(np.zeros((0, 4), np.float32), np.zeros((0,), np.int64))] * 2

    # every int8 site of JAX's forward, its input and output sent out of the jit
    jax_sites = {}
    jax_site = jax_static.static_conv_site

    def recorded(mdl, name, x, *args, **kwargs):
        y = jax_site(mdl, name, x, *args, **kwargs)
        calls = jax_sites.setdefault((".".join(mdl.path), name), [])
        jax.debug.callback(lambda a, b: calls.append((np.asarray(a), np.asarray(b))), x, y,
                           ordered=True)
        return y

    monkeypatch.setattr(jax_static, "static_conv_site", recorded)
    want = jax_d0_harness.make_efficientdet_pred_gt(flax_model, anchors, quant="int8_static")(
        qv, {"image": jnp.asarray(images), "raw": raw})
    jax.effects_barrier()

    net, port_anchors = build_efficientdet("efficientdet-d0", 4, SIZE, device="cpu")
    net = quant_from_flax(qv, bridged(net, variables))
    names = {m: n for n, m in net.named_modules()}
    calls, worst = {}, [0.0]

    def forced(module, suffix, x, *args, **kwargs):
        key = (names[module], suffix[1:])
        i = calls[key] = calls.get(key, -1) + 1
        jax_x, jax_y = jax_sites[key][i]
        y = port_site(module, suffix, nchw(jax_x), *args, **kwargs)
        worst[0] = max(worst[0], float(np.abs(y.permute(0, 2, 3, 1).numpy() - jax_y).max()
                                       / np.abs(jax_y).max()))
        return y

    port_site = d0_backbone.static_conv_site
    monkeypatch.setattr(d0_backbone, "static_conv_site", forced)
    monkeypatch.setattr(d0_bifpn, "static_conv_site", forced)
    got = make_efficientdet_pred_gt(net, port_anchors, quant="int8_static")(
        {"image": torch.from_numpy(images), "raw": raw})
    assert sum(calls.values()) + len(calls) == sum(map(len, jax_sites.values()))
    assert worst[0] <= 1e-6, worst[0]
    for (g_pred, _), (w_pred, _) in zip(got, want):
        assert len(w_pred) > 0 and g_pred.shape == w_pred.shape
        np.testing.assert_array_equal(g_pred[:, 4], w_pred[:, 4])
        np.testing.assert_allclose(g_pred[:, :4], w_pred[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g_pred[:, 5], w_pred[:, 5], rtol=0, atol=1e-4)


def _scaled_v3(seed=0):
    model, iou_type = build_yolo_model("v3", 3, device="cpu")
    init_weights(model, seed)
    with torch.no_grad():                 # tame exp(tw) decode overflow at random init
        for p in model.parameters():
            p.mul_(0.2)
    return model.eval(), iou_type


def test_batched_int8_static_matches_single(rng):
    anchors = np.asarray([[[116, 90], [156, 198], [373, 326]], [[30, 61], [62, 45], [59, 119]],
                          [[10, 13], [16, 30], [33, 23]]], np.float32) * SIZE / 416
    model, _ = _scaled_v3()
    images = rng.uniform(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    prepare_static_int8(model, calibrate_model(model, [images]))
    kw = dict(confidence_thresh=0.0, scores_thresh=0.0, max_output_size=8, quant="int8_static")
    single = make_yolo_predict(model, (SIZE, SIZE), anchors, 3, **kw)
    batched = make_yolo_predict_batched(model, (SIZE, SIZE), anchors, 3, **kw)
    bb, bi, bs, bv = batched(None, images)
    for i in range(3):
        rb, ri, rs, rv = single(None, images[i:i + 1])
        np.testing.assert_array_equal(rv, bv[i])
        np.testing.assert_allclose(rb[rv], bb[i][rv], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ri[rv], bi[i][rv])
    assert bv.any()
    dynamic = make_yolo_predict(model, (SIZE, SIZE), anchors, 3, **{**kw, "quant": "int8"})
    boxes, ids, scores, valid = dynamic(None, images[:1])
    assert valid.any() and np.isfinite(scores[valid]).all() and np.isfinite(boxes[valid]).all()
