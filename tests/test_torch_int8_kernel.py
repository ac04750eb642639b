"""The int8 conv kernels' plain versions and wrappers (``kernels/int8_conv.py``).

No flax here, and ``jax.numpy`` only inside the padded-quantize test, so that the
``cuda`` case runs on a GPU host without flax (``python -m pytest
tests/test_torch_int8_kernel.py -m cuda``).

- The plain versions against a numpy brute force (quantize with float32
  ``x · (127 / a)`` rounded half to even, an int64 im2col sum, the float32
  epilogue): accumulators exactly equal, outputs exactly equal (and in bf16 the
  float32 output rounded), for a dense conv
  (Cin = 3 with K = 27, ragged Cout, stride 2 with Darknet's top-left pad and with
  TF-SAME pads) and a depthwise conv (k 3 and 5), per-tensor and per-channel.
- The packing round-trips (Cin padded to 16 channels, K to 64); the channel-padded
  quantize's plain version equals JAX's ``jnp.clip(jnp.round(x · (127 / a)))``,
  ties at .5 included; the route planners have a route for every conv of YOLOv4
  @640 and EfficientDet-D0 @512; the wrappers refuse what the kernels do not take.
- On the card (``cuda`` marker, skipped without one): both kernels against their
  plain versions, f32 and bf16, per-tensor and per-channel, at the GEMM's and the
  halo tile's edges (Cout 32, 64 and 255; Cin 3; ragged K and M tiles; odd H and W at
  stride 2; k = 5 depthwise): int32 accumulators identical, outputs within
  1e-6·max|plain| (measured: equal); the bf16 output within a bf16 rounding
  (1e-2·max|plain|) of the float32 plain value; the quantize pass equal to its plain
  version.
"""

import numpy as np
import pytest
import torch

from tmv_tpu_torch.kernels.int8_conv import (
    BLOCK_NS, conv_plan, dw_plan, int8_conv, int8_conv_reference, int8_dwconv,
    int8_dwconv_reference, pack_dense, pack_depthwise, quantize_padded,
    quantize_padded_reference, unpack_dense,
)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def brute_force(x, kq_hwio, a, deq, offset, stride, pads, depthwise):
    """NHWC numpy: (acc int64, out float32) of the int8 conv, element by element."""
    scale = np.float32(127.0) / a.astype(np.float32)
    xq = np.clip(np.rint(x * scale), -127, 127).astype(np.int64)
    top, left, bottom, right = pads
    xq = np.pad(xq, ((0, 0), (top, bottom), (left, right), (0, 0)))
    kh, kw, cin, cout = kq_hwio.shape
    b, h, w, _ = xq.shape
    h_out, w_out = (h - kh) // stride + 1, (w - kw) // stride + 1
    acc = np.zeros((b, h_out, w_out, cout), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            patch = xq[:, dy:dy + (h_out - 1) * stride + 1:stride,
                       dx:dx + (w_out - 1) * stride + 1:stride]
            if depthwise:
                acc += patch * kq_hwio[dy, dx, 0].astype(np.int64)
            else:
                acc += patch @ kq_hwio[dy, dx].astype(np.int64)
    out = acc.astype(np.float32) * deq
    if offset is not None:
        out = out + offset
    return acc, out.astype(np.float32)


CASES = [(3, 3, 32, 1, (1, 1, 1, 1), False), (3, 8, 20, 2, (1, 1, 0, 0), False),
         (1, 16, 40, 1, (0, 0, 0, 0), False), (3, 12, 24, 2, (0, 0, 1, 1), False),
         (3, 12, 12, 1, (1, 1, 1, 1), True), (5, 8, 8, 2, (1, 1, 2, 2), True)]


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[f"k{c[0]}cin{c[1]}s{c[3]}{'_dw' if c[5] else ''}"
                                             for c in CASES])
def test_plain_versions_match_a_brute_force(rng, case, per_channel):
    k, cin, cout, stride, pads, depthwise = case
    x = rng.normal(0, 2, (2, 11, 9, cin)).astype(np.float32)
    kq = rng.integers(-127, 128, (k, k, 1 if depthwise else cin, cout)).astype(np.int8)
    a = rng.uniform(0.5, 4, (cin,) if per_channel else ()).astype(np.float32)
    deq = rng.uniform(0, 1e-3, (cout,)).astype(np.float32)
    offset = rng.normal(size=(cout,)).astype(np.float32)
    want_acc, want = brute_force(x, kq, a, deq, None if depthwise else offset, stride, pads,
                                 depthwise)
    t = torch.from_numpy
    if depthwise:
        args = (nchw(x), pack_depthwise(t(kq)), t(a), t(deq), None, k, stride, pads)
        acc, out = int8_dwconv_reference(*args, return_acc=True), int8_dwconv_reference(*args)
    else:
        args = (nchw(x), pack_dense(t(kq)), t(a), t(deq), t(offset), (k, k), stride, pads)
        acc, out = int8_conv_reference(*args, return_acc=True), int8_conv_reference(*args)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), want)
    assert out.is_contiguous(memory_format=torch.channels_last)
    fn = int8_dwconv_reference if depthwise else int8_conv_reference
    assert torch.equal(fn(*args, out_dtype=torch.bfloat16), out.bfloat16())


def test_packing_round_trips(rng):
    kq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 5, 7)).astype(np.int8))
    packed = pack_dense(kq)
    # Cin 5 -> 16 channels a tap, K = 9 * 16 = 144 -> 192 (three 64-deep stages)
    assert packed.shape == (7, 192) and not packed[:, 144:].any()
    taps = packed[:, :144].reshape(7, 9, 16)
    assert not taps[..., 5:].any() and torch.equal(taps[..., :5], kq.reshape(9, 5, 7).permute(2, 0, 1))
    assert torch.equal(unpack_dense(packed, 3, 3, 5), kq)
    wide = torch.from_numpy(rng.integers(-127, 128, (1, 1, 64, 3)).astype(np.int8))
    assert torch.equal(pack_dense(wide), wide.reshape(64, 3).t())      # no padding at all
    assert torch.equal(unpack_dense(pack_dense(wide), 1, 1, 64), wide)
    dw = torch.from_numpy(rng.integers(-127, 128, (5, 5, 1, 6)).astype(np.int8))
    assert torch.equal(pack_depthwise(dw).reshape(5, 5, 1, 6), dw)


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_padded_matches_jax(rng, per_channel):
    import jax.numpy as jnp

    cin = 5
    a = (rng.uniform(0.5, 4, (cin,)) if per_channel else np.asarray(127.0)).astype(np.float32)
    if per_channel:
        a[0] = 127.0
    x = rng.normal(0, 2, (2, 7, 6, cin)).astype(np.float32)
    # ties: x * (127 / a) exactly k + 0.5 (127 / 127 = 1), and the clip
    x[0, 0, :, 0] = [0.5, 1.5, 2.5, -0.5, -2.5, 3e3]
    if not per_channel:
        x[1, 1, :, :] = np.array([126.5, 127.5, -126.5, -127.5, 0.5], np.float32)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * (127.0 / jnp.asarray(a))), -127, 127)
                      .astype(jnp.int8))
    for dtype in (torch.float32, torch.bfloat16):
        xt = nchw(x).to(dtype)
        want_t = want if dtype == torch.float32 else np.asarray(
            jnp.clip(jnp.round(jnp.asarray(xt.float().permute(0, 2, 3, 1).numpy())
                               * (127.0 / jnp.asarray(a))), -127, 127).astype(jnp.int8))
        for fn in (quantize_padded_reference, quantize_padded):
            got = fn(xt, torch.from_numpy(a))
            assert got.shape == (2, 7, 6, 16) and got.dtype == torch.int8
            np.testing.assert_array_equal(got[..., :cin].numpy(), want_t)
            assert not got[..., cin:].any()
    assert list(want[0, 0, :, 0]) == [0, 2, 2, 0, -2, 127]


def test_routes_cover_every_yolov4_and_d0_conv():
    from tmv_tpu_torch.models.efficientdet.harness import efficientdet_config
    from tmv_tpu_torch.models.efficientdet.net import EfficientDetNet
    from tmv_tpu_torch.models.yolo_v4 import YoloV4

    with torch.device("meta"):
        models = [YoloV4(80), EfficientDetNet(efficientdet_config("efficientdet-d0", 81, 512))]
    dense = depthwise = 0
    for model in models:
        for m in model.modules():
            if not isinstance(m, torch.nn.Conv2d):
                continue
            if m.groups == 1:
                plan = conv_plan(m.in_channels, m.out_channels, *m.kernel_size)
                assert plan["cp"] % 16 == 0 and plan["cp"] - m.in_channels < 16
                assert plan["kpad"] % 64 == 0 and plan["kpad"] >= plan["k"]
                assert plan["block_n"] in BLOCK_NS
                assert plan["block_n"] >= min(m.out_channels, BLOCK_NS[-1])
                dense += 1
            else:
                assert m.groups == m.in_channels == m.out_channels
                dw_plan(m.kernel_size[0], m.stride[0])
                depthwise += 1
    assert dense >= 107 + 86 and depthwise >= 16   # the int8 sites: YOLOv4 107, D0 86 dense
    with pytest.raises(ValueError, match="k in"):
        dw_plan(7, 1)


def test_wrappers_refuse_what_the_kernels_do_not_take(rng):
    x = nchw(rng.normal(size=(1, 4, 4, 8)).astype(np.float32))
    packed = pack_dense(torch.zeros((3, 3, 8, 4), dtype=torch.int8))
    deq = torch.ones(4)
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv(x.contiguous(), packed, torch.tensor(1.0), deq, None, (3, 3), 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="kernel_q"):
        int8_conv(x, packed[:, :32].contiguous(), torch.tensor(1.0), deq, None, (3, 3))
    with pytest.raises(ValueError, match="in_absmax"):
        int8_conv(x, packed, torch.ones(3), deq, None, (3, 3))
    with pytest.raises(ValueError, match="kernel_q"):
        int8_dwconv(x, torch.zeros((9, 4), dtype=torch.int8), torch.tensor(1.0),
                    torch.ones(8), None, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        int8_conv(x.half(), packed, torch.tensor(1.0), deq, None, (3, 3))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the new design's edges: Cout 32 / 64 / 255 (one BN tile, a ragged 128-wide tile),
# Cin 3 (16-channel chunks), ragged K (Cin 24, 40: K not a multiple of 64) and M
# tiles (2 x 17 x 13 pixels), stride 2 on odd H and W, k = 5 depthwise at both strides
CARD_CASES = CASES + [(1, 64, 130, 1, (0, 0, 0, 0), False), (3, 3, 32, 2, (1, 1, 0, 0), False),
                      (1, 64, 64, 1, (0, 0, 0, 0), False), (1, 40, 255, 1, (0, 0, 0, 0), False),
                      (3, 24, 255, 1, (1, 1, 1, 1), False), (3, 64, 32, 2, (1, 1, 0, 0), False),
                      (5, 40, 40, 1, (2, 2, 2, 2), True), (5, 24, 24, 2, (1, 1, 2, 2), True),
                      (3, 96, 96, 2, (0, 0, 1, 1), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernels_match_plain_on_card(cuda, rng, dtype):
    for per_channel in (False, True):
        for k, cin, cout, stride, pads, depthwise in CARD_CASES:
            x = nchw(rng.normal(0, 2, (2, 17, 13, cin)).astype(np.float32)).to(cuda, dtype)
            kq = torch.from_numpy(rng.integers(-127, 128, (k, k, 1 if depthwise else cin, cout))
                                  .astype(np.int8))
            a = torch.from_numpy(rng.uniform(0.5, 4, (cin,) if per_channel else ()).astype(
                np.float32)).to(cuda)
            deq = torch.from_numpy(rng.uniform(0, 1e-3, (cout,)).astype(np.float32)).to(cuda)
            off = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)).to(cuda)
            if depthwise:
                args = (x, pack_depthwise(kq).to(cuda), a, deq, None, k, stride, pads)
                kernel, plain = int8_dwconv, int8_dwconv_reference
            else:
                args = (x, pack_dense(kq).to(cuda), a, deq, off, (k, k), stride, pads)
                kernel, plain = int8_conv, int8_conv_reference
            assert torch.equal(kernel(*args, return_acc=True), plain(*args, return_acc=True))
            if not depthwise:
                assert torch.equal(quantize_padded(x, a), quantize_padded_reference(x, a))
            want = plain(*args)
            assert (kernel(*args) - want).abs().max() <= 1e-6 * want.abs().max()
            got = kernel(*args, out_dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16
            assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()
