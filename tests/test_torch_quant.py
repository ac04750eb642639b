"""The port's int8 convolutions, prepare, calibration and int8 ConvBN
(``tmv_tpu_torch.quant``, ``kernels/int8_conv.py``) against ``tmv_tpu.quant`` on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

- The convs: ``static_int8_conv`` (k 1 and 3, stride 1 and 2 with Darknet's top-left
  pad and with TF-SAME, Cin = 3, per-tensor and per-channel, with a BN-style
  ``out_scale``/``out_offset``, a bias, or neither; depthwise k 3 and 5 at stride 1
  and 2) and ``dynamic_int8_conv``: the quantized input ``xq`` and the int32
  accumulator exactly equal to XLA's, the output within 2 float32 ulps (measured:
  equal).
- Prepare: ``prepare_static_int8`` fed the JAX calibration (through
  ``quant_stats_from_flax``) against ``prepare_static_int8_variables``, per-tensor
  and per-channel, margin 1 and 0.5, on a ConvBN stack and on three D0 backbone
  stages (the grouped fold of the depthwise convs): ``kernel_q``, ``w_absmax`` and
  ``in_absmax`` bit-equal, and ``quant_from_flax`` installs the same buffers.
- Calibration: the port's ``calibrate_model`` against JAX's on the same weights and
  batches, on the whole YOLOv4 (107 ConvBN sites) and the whole D0 (the BiFPN and
  head SeparableConvs shared over five levels, through the stock depthwise, not
  the fused kernel, as JAX's): the same sites, the per-channel absmax within 1e-5
  of the site's largest (sums taken in another order upstream; the first site
  sees the image itself and is equal).
- ConvBN in ``int8_static`` (from JAX's ``quant`` collection) and ``int8`` against
  flax's, strides 1 and 2: within 1e-6·max|JAX| (the activations' float rounding);
  train mode ignores the mode; prepare leaves the ``state_dict`` unchanged.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.efficientdet.backbone import BackboneModel as FlaxBackbone
from tmv_tpu.models.efficientdet.config import default_blocks_args
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu.quant import calibrate_model as jax_calibrate
from tmv_tpu.quant import prepare_static_int8_variables
from tmv_tpu.quant import quantized as jax_quantized
from tmv_tpu.quant.dynamic import dynamic_int8_conv as jax_dynamic_conv
from tmv_tpu.quant.static import static_int8_conv as jax_static_conv
from tmv_tpu_torch.convert.flax_bridge import (
    _leaves, flax_to_state_dict, quant_from_flax, quant_stats_from_flax,
)
from tmv_tpu_torch.kernels.int8_conv import (
    int8_conv, int8_dwconv, pack_dense, pack_depthwise, quantize_reference, unpack_dense,
)
from tmv_tpu_torch.models.efficientdet import backbone as d0_backbone
from tmv_tpu_torch.models.efficientdet.backbone import BackboneModel
from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet, efficientdet_config
from tmv_tpu_torch.models.layers.common import ConvBN
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from tmv_tpu_torch.quant import (
    calibrate_model, dynamic_int8_conv, prepare_static_int8, quantized, static_int8_conv,
)
from tmv_tpu_torch.quant.dynamic import conv_pads
from tmv_tpu_torch.quant.static import site_parts, static_epilogue
from torch_port_cases import one_torch_thread, seeded_variables  # noqa: F401


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def seeded(flax_module, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.key(0), *inputs, **kw))
    return jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(seed)))


def bridged(module, variables):
    plain = {k: variables[k] for k in ("params", "batch_stats")}
    module.load_state_dict(flax_to_state_dict(plain, module), strict=True)
    return module.eval()


def jax_pads(x, padding):
    """JAX's input and padding for a port padding: Darknet's stride-2 conv pads
    top-left and runs VALID."""
    if padding == "darknet":
        return jnp.pad(x, ((0, 0), (1, 0), (1, 0), (0, 0))), "VALID", (1, 1, 0, 0)
    return x, "SAME", "SAME"


# (k, stride, padding, Cin, Cout, per_channel, epilogue, depthwise)
CONV_CASES = [
    (3, 1, "same", 8, 16, False, "bn", False),
    (3, 1, "same", 8, 16, True, "bn", False),
    (1, 1, "same", 16, 24, False, "bias", False),
    (1, 1, "same", 16, 24, True, None, False),
    (3, 2, "darknet", 8, 12, False, "bn", False),
    (3, 2, "darknet", 8, 12, True, "bn", False),
    (3, 1, "same", 3, 32, False, "bn", False),       # K = 27
    (3, 2, "same", 3, 24, True, "bn", False),        # the D0 stem: TF-SAME at stride 2
    (3, 1, "same", 12, 12, False, None, True),
    (3, 2, "same", 12, 12, True, "bn", True),
    (5, 1, "same", 16, 16, True, "bn", True),
    (5, 2, "same", 16, 16, False, None, True),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[
    f"k{c[0]}s{c[1]}_{c[2]}_cin{c[3]}_{'pc' if c[5] else 'pt'}_{c[6]}{'_dw' if c[7] else ''}"
    for c in CONV_CASES])
def test_static_conv_matches_jax(rng, case):
    k, stride, padding, cin, cout, per_channel, epilogue, depthwise = case
    x = rng.normal(0, 1.5, (2, 11, 9, cin)).astype(np.float32)
    kernel_q = rng.integers(-127, 128, (k, k, 1 if depthwise else cin, cout)).astype(np.int8)
    w_absmax = rng.uniform(0.05, 1.0, (cout,)).astype(np.float32)
    in_absmax = (rng.uniform(0.5, 4.0, (cin,)) if per_channel else np.asarray(2.3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (cout,)).astype(np.float32) if epilogue == "bn" else None
    offset = rng.normal(0, 1, (cout,)).astype(np.float32) if epilogue else None
    xj, jax_padding, padding = jax_pads(jnp.asarray(x), padding)
    groups = cin if depthwise else 1
    want = jax_static_conv(xj, jnp.asarray(kernel_q), jnp.asarray(in_absmax),
                           jnp.asarray(w_absmax), (stride, stride), jax_padding,
                           None if scale is None else jnp.asarray(scale),
                           None if offset is None else jnp.asarray(offset), groups)
    packed = (pack_depthwise if depthwise else pack_dense)(torch.from_numpy(kernel_q))
    t = torch.from_numpy
    got = static_int8_conv(nchw(x), packed, t(in_absmax), t(w_absmax), (k, k), stride, padding,
                           None if scale is None else t(scale),
                           None if offset is None else t(offset), groups)
    np.testing.assert_array_max_ulp(nhwc(got), np.asarray(want), maxulp=2)

    # xq and the int32 accumulator: exactly XLA's
    xq_want = jnp.clip(jnp.round(xj.astype(jnp.float32) * (127.0 / jnp.asarray(in_absmax))),
                       -127, 127).astype(jnp.int8)
    acc_want = jax.lax.conv_general_dilated(
        xq_want, jnp.asarray(kernel_q), (stride, stride), jax_padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)
    xq = quantize_reference(nchw(x), t(in_absmax))
    xq_jax = np.asarray(xq_want)[:, 1:, 1:] if jax_padding == "VALID" else np.asarray(xq_want)
    np.testing.assert_array_equal(nhwc(xq), xq_jax)
    deq, off = static_epilogue(t(in_absmax), t(w_absmax))
    pads = padding if padding != "SAME" else conv_pads(x.shape[1:3], (k, k), stride, "SAME")
    if depthwise:
        acc = int8_dwconv(nchw(x), packed, t(in_absmax), deq, off, k, stride, pads, True)
    else:
        acc = int8_conv(nchw(x), packed, t(in_absmax), deq, off, (k, k), stride, pads, True)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(nhwc(acc), np.asarray(acc_want))


@pytest.mark.parametrize("k, stride, padding, folded", [
    (3, 1, "same", True), (3, 2, "darknet", True), (1, 1, "same", False), (3, 1, "same", False)])
def test_dynamic_conv_matches_jax(rng, k, stride, padding, folded):
    x = rng.normal(0, 2, (2, 10, 7, 8)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, 8, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (16,)).astype(np.float32) if folded else None
    offset = rng.normal(0, 1, (16,)).astype(np.float32) if folded else None
    xj, jax_padding, padding = jax_pads(jnp.asarray(x), padding)
    want = jax_dynamic_conv(xj, jnp.asarray(w), (stride, stride), jax_padding,
                            None if scale is None else jnp.asarray(scale),
                            None if offset is None else jnp.asarray(offset))
    got = dynamic_int8_conv(nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1), stride, padding,
                            None if scale is None else torch.from_numpy(scale),
                            None if offset is None else torch.from_numpy(offset))
    np.testing.assert_array_max_ulp(nhwc(got), np.asarray(want), maxulp=2)


class _FlaxStack(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x, train: bool = False):
        x = FlaxConvBN(16, 3, act="mish")(x, train)
        x = FlaxConvBN(24, 3, strides=2, act="leaky")(x, train)
        return FlaxConvBN(8, 1, act="linear")(x, train)


class _Stack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvBN_0 = ConvBN(4, 16, 3, act="mish")
        self.ConvBN_1 = ConvBN(16, 24, 3, strides=2, act="leaky")
        self.ConvBN_2 = ConvBN(24, 8, 1, act="linear")

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return nhwc_t(self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x))))


def nhwc_t(t):
    return t.permute(0, 2, 3, 1)


def _stack_pair(rng):
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    x[..., 0] *= 20.0                     # a skewed channel: per-channel scales differ
    flax_model = _FlaxStack()
    variables = seeded(flax_model, jnp.asarray(x), train=False)
    return flax_model, variables, bridged(_Stack(), variables), x


def _quant_leaves(model):
    return {f"{name}.{b}" if name else b: t for name, m in model.named_modules()
            for b, t in m.named_buffers(recurse=False)
            if b.startswith(("in_absmax", "kernel_q", "w_absmax"))}


def _assert_prepared_like_jax(model, quant_tree):
    """Every leaf of JAX's ``quant`` collection bit-equal to the port's buffer (a
    ``kernel_q`` read back to HWIO) → the number of leaves."""
    leaves = _quant_leaves(model)
    count = 0
    for path, want in _leaves(quant_tree):
        *modules, leaf = path
        got, want = leaves[".".join(modules + [leaf])], np.asarray(want)
        if leaf.startswith("kernel_q"):
            conv, _ = site_parts(model.get_submodule(".".join(modules)), leaf[len("kernel_q"):])
            kh, kw, cin, cout = want.shape
            got = (got.reshape(kh, kw, 1, cout) if conv.groups > 1
                   else unpack_dense(got, kh, kw, cin))
        assert got.dtype == torch.from_numpy(np.array(want)).dtype, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg="/".join(path))
        count += 1
    assert count == len(leaves)
    return count


@pytest.mark.parametrize("per_channel, margin", [(False, 1.0), (True, 1.0), (False, 0.5),
                                                 (True, 0.5)])
def test_prepare_matches_jax_on_a_convbn_stack(rng, per_channel, margin):
    flax_model, variables, stack, x = _stack_pair(rng)
    stats = jax_calibrate(flax_model, variables, [jnp.asarray(x), jnp.asarray(x * 0.5)],
                          train=False)
    want = prepare_static_int8_variables(variables, stats, margin=margin,
                                         per_channel=per_channel)["quant"]
    before = {k: v.clone() for k, v in stack.state_dict().items()}
    prepare_static_int8(stack, quant_stats_from_flax(stats), margin=margin,
                        per_channel=per_channel)
    assert _assert_prepared_like_jax(stack, want) == 9
    after = stack.state_dict()
    assert list(after) == list(before) and all(torch.equal(after[k], before[k]) for k in before)
    assert stack.ConvBN_0.in_absmax.shape == ((4,) if per_channel else ())

    # the same outputs from JAX's collection carried by the bridge
    quant_from_flax({"quant": want}, stack)
    assert _assert_prepared_like_jax(stack, want) == 9
    with jax_quantized("int8_static"):
        ref = flax_model.apply({**variables, "quant": want}, jnp.asarray(x), train=False)
    with quantized("int8_static"), torch.no_grad():
        got = stack(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("per_channel", [False, True])
def test_prepare_matches_jax_through_depthwise_blocks(rng, per_channel):
    """Three D0 backbone stages: the stem, expand, depthwise (grouped fold) and
    project sites."""
    blocks = tuple(default_blocks_args()[:3])
    flax_model = FlaxBackbone(blocks_args=blocks)
    x = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    variables = seeded(flax_model, jnp.asarray(x), train=False)
    stats = jax_calibrate(flax_model, variables, [jnp.asarray(x)], train=False)
    want = prepare_static_int8_variables(variables, stats, per_channel=per_channel)["quant"]
    port = bridged(BackboneModel(blocks), variables)
    prepare_static_int8(port, quant_stats_from_flax(stats), per_channel=per_channel)
    leaves = _quant_leaves(port)
    assert [k for k in leaves if "kernel_q" in k and leaves[k].shape[0] in (9, 25)]  # depthwise
    assert _assert_prepared_like_jax(port, want) == len(leaves)
    with jax_quantized("int8_static"):
        ref = flax_model.apply({**variables, "quant": want}, jnp.asarray(x), train=False)
    with quantized("int8_static"), torch.no_grad():
        got = port(nchw(x))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(nhwc(g), r, rtol=0, atol=1e-5 * np.abs(r).max())


def _calib_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-5 * w.max(), err_msg=key)


def test_calibration_matches_jax_on_yolov4(one_torch_thread):
    flax_model = FlaxYoloV4(classes_num=2)
    images = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = seeded(flax_model, jnp.asarray(images[:1]), train=False, seed=3)
    batches = [images[:1], images[1:] * 0.8]
    want = quant_stats_from_flax(jax_calibrate(flax_model, variables,
                                               [jnp.asarray(b) for b in batches], train=False))
    model = bridged(YoloV4(2), variables)
    got = calibrate_model(model, batches)
    assert len(got) == 107 and all(k.endswith(".in_absmax") for k in got)
    _calib_close(got, want)
    np.testing.assert_array_equal(got["ConvBN_0.in_absmax"], want["ConvBN_0.in_absmax"])


def test_calibration_matches_jax_on_d0(one_torch_thread, monkeypatch):
    size = 64
    cfg = efficientdet_config("efficientdet-d0", 4, size)
    cfg.fused_dw_eval = False
    flax_model = FlaxEfficientDetNet(config=cfg)
    images = np.random.default_rng(5).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    variables = seeded(flax_model, jnp.asarray(images), train=False, seed=5)
    want = quant_stats_from_flax(jax_calibrate(flax_model, variables, [jnp.asarray(images)],
                                               train=False))
    net, _ = build_efficientdet("efficientdet-d0", 4, size, device="cpu")

    def fused(*args):
        raise AssertionError("a calibrating forward launched the fused depthwise kernel")

    monkeypatch.setattr(d0_backbone, "fused_dw_bn_swish", fused)   # JAX's stock path
    got = calibrate_model(bridged(net, variables), [images])
    _calib_close(got, want)
    shared = [k for k in got if ".fpn_cell_" in k or "_net.net.conv_" in k]
    assert shared and not any("predict" in k for k in got)


@pytest.mark.parametrize("strides", [1, 2])
@pytest.mark.parametrize("mode", ["int8_static", "int8"])
def test_convbn_int8_matches_flax(rng, strides, mode):
    flax_model = FlaxConvBN(16, 3, strides=strides, act="mish")
    x = rng.normal(size=(2, 11, 11, 8)).astype(np.float32)
    variables = seeded(flax_model, jnp.asarray(x), train=False)
    port = bridged(ConvBN(8, 16, 3, strides, act="mish"), variables)
    if mode == "int8_static":
        stats = jax_calibrate(flax_model, variables, [jnp.asarray(x)], train=False)
        variables = prepare_static_int8_variables(variables, stats)
        quant_from_flax(variables, port)
    with jax_quantized(mode):
        want = np.asarray(flax_model.apply(variables, jnp.asarray(x), train=False))
    with quantized(mode), torch.no_grad():
        got = nhwc(port(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():
        float_out = nhwc(port(nchw(x)))
    assert np.abs(float_out - got).max() > 0     # the int8 path really ran


def test_convbn_train_mode_ignores_the_mode(rng):
    x = nchw(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    port = ConvBN(4, 8, 3, act="leaky")
    twin = ConvBN(4, 8, 3, act="leaky")
    twin.load_state_dict(port.state_dict())
    with quantized("int8"):
        got = port.train()(x)
    want = twin.train()(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(port.state_dict().values(), twin.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

