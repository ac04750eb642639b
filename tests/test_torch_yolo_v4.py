"""The port's YOLOv4 (tmv_tpu_torch.models.yolo_v4) against the flax model, in f32.

Each stage at narrow widths and a small spatial size, then the whole
``YoloV4(classes_num=2)`` at its fixed full width on a 64×64 input, all on
bridged seeded weights whose BatchNorm statistics are not trivial. Flax runs
eagerly (no jit compile). XLA's and PyTorch's CPU convolutions sum in other
orders, so the tolerances are stated against the largest reference value, with
rtol 1e-5: atol 5e-6·max|ref| for a stage (measured up to 6.4e-7) and
2e-5·max|ref| for the full heads, which reach |ref| ~ 1e4-1e5 after ~110 layers
(measured up to 3e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models import yolo_v4 as fy
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models import yolo_v4 as ty
from torch_port_cases import seeded_variables


def bridged(flax_module, torch_module, rng, *inputs):
    shapes = jax.eval_shape(flax_module.init, jax.random.key(0), *map(jnp.asarray, inputs))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    torch_module.load_state_dict(flax_to_state_dict(variables, torch_module), strict=True)
    return variables, torch_module.eval()


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def assert_close(got, want, rel):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=rel * np.abs(want).max())


STAGES = {
    "BlocksLayer": (lambda: fy.BlocksLayer(16), lambda: ty.BlocksLayer(8, 16),
                    [(2, 16, 16, 8)]),
    "BlocksLayer2": (lambda: fy.BlocksLayer2(16, 1), lambda: ty.BlocksLayer2(8, 16, 1),
                     [(2, 16, 16, 8)]),
    "LastLayer": (lambda: fy.LastLayer(8), lambda: ty.LastLayer(12, 8), [(2, 7, 7, 12)]),
    "LastLayer2": (lambda: fy.LastLayer2(8), lambda: ty.LastLayer2(12, 10, 8),
                   [(2, 5, 5, 12), (2, 10, 10, 10)]),
    "OutputLayer2": (lambda: fy.OutputLayer2(8), lambda: ty.OutputLayer2(6, 16, 8),
                     [(2, 10, 10, 6), (2, 5, 5, 16)]),
}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_matches_flax(rng, name):
    make_flax, make_torch, input_shapes = STAGES[name]
    inputs = [rng.normal(size=s).astype(np.float32) for s in input_shapes]
    flax_module = make_flax()
    variables, net = bridged(flax_module, make_torch(), rng, *inputs)
    want = flax_module.apply(variables, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = net(*map(nchw, inputs))
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            assert_close(nhwc(g), w, 5e-6)
    else:
        assert_close(nhwc(got), want, 5e-6)


@pytest.fixture(scope="module")
def full_model():
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    flax_model = fy.YoloV4(classes_num=2)
    variables, net = bridged(flax_model, ty.YoloV4(classes_num=2), rng, image)
    heads = [np.asarray(h) for h in flax_model.apply(variables, jnp.asarray(image))]
    return image, variables, net, heads


def test_full_yolov4_heads_match_flax(full_model):
    image, _, net, want = full_model
    with torch.inference_mode():
        got = net(torch.from_numpy(image))
    assert [tuple(g.shape) for g in got] == [(1, 2, 2, 21), (1, 4, 4, 21), (1, 8, 8, 21)]
    for g, w in zip(got, want):
        assert_close(g.numpy(), w, 2e-5)


def test_bf16_model_runs_on_bridged_weights(full_model):
    """The bf16 mode (what ``--bf16`` serves): bf16 convs, f32 BatchNorm. Not
    held to JAX; held to the f32 heads at bf16's 8-bit mantissa through ~110
    layers (5e-2·max|ref|)."""
    image, _, net, want = full_model
    net16 = ty.YoloV4(classes_num=2, dtype=torch.bfloat16)
    net16.load_state_dict(net.state_dict(), strict=True)
    assert net16.ConvBN_0.DarknetConv_0.Conv_0.weight.dtype == torch.bfloat16
    assert net16.ConvBN_0.BatchNorm_0.running_var.dtype == torch.float32
    with torch.inference_mode():
        got = net16.eval()(torch.from_numpy(image))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=5e-2 * np.abs(w).max())
