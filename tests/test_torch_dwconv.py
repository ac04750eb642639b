"""The fused depthwise conv + BatchNorm + swish: the plain version against the TPU
kernel, the wrapper's checks, and the CUDA kernel against the plain version.

- On the CPU, ``dw_bn_swish_reference`` is held against the Pallas kernel
  ``fused_dw_bn_swish(..., interpret=True)`` and against the XLA
  ``dw_reference`` on the cases of ``tests/test_dwconv_pallas.py``: k in {3, 5}
  × stride in {1, 2}, ragged heights, odd sizes at stride 2, batch boundaries,
  bf16 I/O, plus H = W = 1 and a C that is not a multiple of 4. float32 agrees
  within 1e-5·max|ref| (the k² sum is taken in another order); bfloat16 within
  one bfloat16 step of the reference value plus that float32 tolerance (where the
  sum cancels to near 0, a relative step is smaller than the float32 difference).
- The wrapper refuses wrong layouts, dtypes, shapes, k, strides and devices on
  every device, and on a CPU tensor runs the plain version without a launch.
- The ``cuda`` cases build the kernel and compare it with the plain version on
  the card at every EfficientDet-D0 @512 depthwise shape and at the edge shapes,
  in float32 (TF32 off) and bfloat16, then at shapes that cut the kernel's 8 x 8
  pixel tiles and 32-channel chunks raggedly, and check that every
  instantiation stays within 128 registers without spilling. They skip without a
  card; on the GPU host run
  them with ``python -m pytest tests/test_torch_dwconv.py -m cuda`` (that host
  need not have jax, which is imported only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from tmv_tpu_torch.kernels import dwconv
from tmv_tpu_torch.kernels.dwconv import dw_bn_swish_reference, fused_dw_bn_swish

# (B, H, W, C, k, stride): the Pallas kernel's test cases, then the edges
CASES = [(2, 16, 16, 8, k, s) for k in (3, 5) for s in (1, 2)] + [
    (1, 15, 9, 4, 3, 1),    # ragged height tiles
    (1, 13, 11, 4, 5, 2),   # odd H/W at stride 2: asymmetric TF-SAME pads
    (5, 15, 9, 4, 3, 1),    # batch boundaries of the flattened grid
    (1, 1, 1, 8, 3, 2),     # H = W = 1
    (2, 9, 7, 6, 5, 1),     # C not a multiple of the 4-channel vector
]
# Every depthwise shape of EfficientDet-D0 @512: (input H=W, C, k, stride).
# (B, H, W, C, k, stride) that cut the kernel's tiles raggedly: H, W not
# multiples of 8, C in {4, 6, 24, 144, 240} (C % 32 != 0; 6 takes the
# element-by-element staging), H = W = 1, odd sizes at stride 2
RAGGED_CASES = [(1, 19, 21, 144, 5, 1), (2, 23, 17, 240, 3, 2), (1, 1, 1, 240, 5, 1),
                (1, 1, 1, 4, 3, 2), (3, 9, 10, 24, 5, 2), (2, 12, 13, 6, 3, 1),
                (1, 31, 29, 144, 5, 2), (2, 10, 9, 4, 5, 1), (1, 17, 15, 24, 3, 1),
                (1, 33, 35, 6, 5, 2), (2, 7, 7, 240, 5, 2), (1, 3, 5, 144, 3, 1)]
D0_SHAPES = [(256, 32, 3, 1), (256, 96, 3, 2), (128, 144, 3, 1), (128, 144, 5, 2),
             (64, 240, 5, 1), (64, 240, 3, 2), (32, 480, 3, 1), (32, 480, 5, 1),
             (32, 672, 5, 1), (32, 672, 5, 2), (16, 1152, 5, 1), (16, 1152, 3, 1)]


def make_case(rng, b, h, w, c, k):
    """NHWC numpy inputs, as ``tests/test_dwconv_pallas.py`` makes them."""
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = rng.normal(size=(k, k, c)).astype(np.float32) * 0.3
    scale = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    offset = rng.normal(size=(c,)).astype(np.float32) * 0.1
    return x, wt, scale, offset


def to_torch(x, wt, scale, offset, dtype=torch.float32, device="cpu"):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(device=device, dtype=dtype)
    xt = xt.contiguous(memory_format=torch.channels_last)
    return (xt, *(torch.from_numpy(a).to(device) for a in (wt, scale, offset)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


def bf16_step(v):
    """One bfloat16 step (8 significant bits) at the magnitude of ``v``."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1), e - 8)


def assert_close_f32(got, want):
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def assert_within_one_bf16_step(got, want):
    """One bfloat16 step of ``want``, on top of the float32 tolerance: where the
    k² sum cancels to near 0, the two float32 sums differ by more than a bf16 step
    of their tiny result, and rounding keeps that difference."""
    tol = bf16_step(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_reference_matches_pallas_and_xla(rng, case):
    import jax.numpy as jnp
    from tmv_tpu.kernels.dwconv_pallas import dw_reference
    from tmv_tpu.kernels.dwconv_pallas import fused_dw_bn_swish as pallas_dw

    b, h, w, c, k, stride = case
    arrays = make_case(rng, b, h, w, c, k)
    got = nhwc(dw_bn_swish_reference(*to_torch(*arrays), stride))
    xla = np.asarray(dw_reference(*map(jnp.asarray, arrays), stride))
    assert got.shape == xla.shape
    assert_close_f32(got, xla)
    pallas = np.asarray(pallas_dw(*map(jnp.asarray, arrays), stride, row_tile=4,
                                  interpret=True))
    assert_close_f32(got, pallas)


@pytest.mark.parametrize("stride", [1, 2])
def test_reference_bf16_io_within_one_step(rng, stride):
    import jax.numpy as jnp
    from tmv_tpu.kernels.dwconv_pallas import dw_reference
    from tmv_tpu.kernels.dwconv_pallas import fused_dw_bn_swish as pallas_dw

    x, wt, scale, offset = make_case(rng, 1, 12, 12, 8, 3)
    out = dw_bn_swish_reference(*to_torch(x, wt, scale, offset, torch.bfloat16), stride)
    assert out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    for ref in (dw_reference(xb, wt, scale, offset, stride),
                pallas_dw(xb, wt, scale, offset, stride, row_tile=4, interpret=True)):
        assert_within_one_bf16_step(nhwc(out), np.asarray(ref, np.float32))


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    args = to_torch(*make_case(rng, 2, 9, 7, 8, 5))
    before = dwconv.launches
    got = fused_dw_bn_swish(*args, 2)
    assert dwconv.launches == before              # no kernel ran
    assert torch.equal(got, dw_bn_swish_reference(*args, 2))
    assert got.shape == (2, 8, 5, 4) and got.is_contiguous(memory_format=torch.channels_last)


def test_wrapper_refuses_wrong_layouts_dtypes_and_devices(rng):
    x, w, scale, offset = to_torch(*make_case(rng, 1, 8, 8, 8, 3))
    ok = dict(x=x, w=w, scale=scale, offset=offset, stride=1)
    bad = [
        (dict(x=x.contiguous()), "channels_last"),                 # NCHW-contiguous
        (dict(x=x.half()), "float32 or bfloat16"),
        (dict(x=x[0]), "4-d"),
        (dict(w=w.double()), "taps must be contiguous float32"),
        (dict(w=w[:, :, :4].contiguous()), r"taps must be \(k, k, 8\)"),
        (dict(w=torch.zeros(7, 7, 8)), "k in"),
        (dict(w=w.transpose(0, 1)), "taps must be contiguous"),
        (dict(scale=scale.bfloat16()), "scale must be"),
        (dict(offset=offset[:4]), "offset must be"),
        (dict(stride=3), "stride must be 1 or 2"),
        (dict(scale=scale.to("meta")), "scale is on meta"),
    ]
    for change, message in bad:
        with pytest.raises(ValueError, match=message):
            fused_dw_bn_swish(**{**ok, **change})
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in ok.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_dw_bn_swish(**meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the depthwise kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_reference_on_card(cuda, dtype):
    rng = np.random.default_rng(7)
    shapes = [(b, hw, hw, c, k, s) for hw, c, k, s in D0_SHAPES for b in (1, 2)] + CASES
    for b, h, w, c, k, stride in shapes:
        args = to_torch(*make_case(rng, b, h, w, c, k), dtype, cuda)
        before = dwconv.launches
        got = fused_dw_bn_swish(*args, stride)
        assert dwconv.launches == before + 1
        want = dw_bn_swish_reference(*args, stride)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            assert_close_f32(nhwc(got), nhwc(want))
        else:
            assert_within_one_bf16_step(nhwc(got), nhwc(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_ragged_tiles_on_card(cuda, dtype):
    rng = np.random.default_rng(8)
    for b, h, w, c, k, stride in RAGGED_CASES:
        args = to_torch(*make_case(rng, b, h, w, c, k), dtype, cuda)
        got = fused_dw_bn_swish(*args, stride)
        want = dw_bn_swish_reference(*args, stride)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape, (b, h, w, c, k, stride)
        if dtype == torch.float32:
            assert_close_f32(nhwc(got), nhwc(want))
        else:
            assert_within_one_bf16_step(nhwc(got), nhwc(want))


@pytest.mark.cuda
def test_kernel_register_budget_on_card(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        for k in (3, 5):
            for stride in (1, 2):
                info = dwconv.kernel_info(k, stride, dtype)
                assert info["registers"] <= 128 and info["spill_bytes"] == 0, (k, stride, info)
                assert info["blocks_per_sm"] * info["threads"] >= 256, (k, stride, info)
