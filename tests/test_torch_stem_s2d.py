"""``ops/space_to_depth.py`` and ``Stem(stem_s2d=True)`` against the JAX package.

- ``space_to_depth`` and ``stem_kernel_to_s2d`` equal ``tmv_tpu/ops/space_to_depth.py``'s
  exactly (NCHW/OIHW against NHWC/HWIO);
- the port's s2d stem against the flax ``Stem(stem_s2d=True)`` on bridged seeded
  weights (``hold_against_flax``: eval in float32, train in float64 with the
  BatchNorm updates);
- the s2d stem against the direct 3x3 stride-2 stem on the same weights (float32
  within 1e-5·max, float64 within 1e-12·max), and ``cfg.stem_s2d`` reaching the stem
  through ``EfficientDetNet``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.efficientdet.backbone import Stem as FlaxStem
from tmv_tpu.ops import space_to_depth as jax_s2d
from tmv_tpu_torch.models.efficientdet.backbone import Stem
from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet, efficientdet_config
from tmv_tpu_torch.models.efficientdet.net import EfficientDetNet
from tmv_tpu_torch.ops.space_to_depth import space_to_depth, stem_kernel_to_s2d
from torch_port_cases import hold_against_flax


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 10, 5)])
def test_space_to_depth_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_s2d.space_to_depth(jnp.asarray(x), 2))
    got = space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin, cout", [(3, 32), (5, 7)])
def test_stem_kernel_to_s2d_matches_jax(cin, cout):
    w = np.random.default_rng(1).normal(size=(3, 3, cin, cout)).astype(np.float32)
    want = np.asarray(jax_s2d.stem_kernel_to_s2d(jnp.asarray(w)))
    got = stem_kernel_to_s2d(torch.from_numpy(w).permute(3, 2, 0, 1)).permute(2, 3, 1, 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_odd_sizes_are_refused():
    with pytest.raises(ValueError, match="divisible"):
        space_to_depth(torch.zeros(1, 3, 5, 4))
    with pytest.raises(ValueError, match="3x3"):
        stem_kernel_to_s2d(torch.zeros(8, 3, 5, 5))


@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (1, 30, 34, 3)])
def test_s2d_stem_matches_flax(shape):
    flax_stem = FlaxStem(32, 1.0, 8, stem_s2d=True)
    hold_against_flax(flax_stem, Stem(32, 1.0, 8, stem_s2d=True), shape, seed=2)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_s2d_stem_equals_the_direct_stem(dtype, tol):
    direct, s2d = Stem(32, 1.0, 8), Stem(32, 1.0, 8, stem_s2d=True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in direct.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
    s2d.load_state_dict(direct.state_dict())
    x = torch.rand((2, 3, 64, 80), generator=gen).to(dtype)
    direct, s2d = direct.to(dtype).eval(), s2d.to(dtype).eval()
    with torch.no_grad():
        want, got = direct(x), s2d(x)
    assert got.shape == want.shape == (2, 32, 32, 40)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_config_flag_reaches_the_stem():
    cfg = efficientdet_config("efficientdet-d0", 4, 64)
    assert not build_efficientdet("efficientdet-d0", 4, 64, device="meta")[0] \
        .backbone.Stem_0.stem_s2d
    cfg.stem_s2d = True
    assert EfficientDetNet(cfg, device="meta").backbone.Stem_0.stem_s2d
