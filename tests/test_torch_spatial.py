"""The port's height-sharded forward against the JAX package's unsharded one, on the CPU.

The same seeded numpy images and bridged weights (non-trivial BatchNorm statistics) go
through the flax model's ``apply`` on one device and through the port's forward split
over 2 and 4 in-process shards (``parallel.inference.shard_predict_spatial``, the
halo exchanges of ``parallel/halo.py``). JAX's own tests show that its spatial program
equals its unsharded one, so the unsharded program is the reference. XLA's and
PyTorch's CPU convolutions sum in other orders, and a shard's convs run at other
shapes: the heads are held to 2e-5·max|ref| (rtol 1e-5), ``test_torch_yolo_v4.py``'s
whole-model tolerance; D0 to 1e-5·max|ref|, ``test_torch_efficientdet.py``'s.

- the ConvBN stack (16 px; the second conv a Darknet stride-2, whose pad and halo are
  on top);
- YOLOv4 and YOLOv3 at 1/8 width (``torch_spatial_cases``) at 64 px: over 4 shards the
  stride-32 level has 2 rows and runs gathered on every shard, over 2 it splits;
- SPP's 13/9/5 pools at 20 rows over 4 shards (a 6-row halo on 5-row shards, from two
  shards away) and at 32 rows over 2;
- EfficientDet-D0 at 64 px (TF-SAME stride-2 convs pad at the bottom, so their halo
  comes from below; the squeeze-excitation means over the whole image; the P6/P7
  levels of 1 row run gathered);
- the control: the same forward with every other shard's rows replaced by zeros
  fails the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_spatial_cases as sc
from tmv_tpu.models import yolo_v4 as fy
from tmv_tpu.models.efficientdet.net import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models import yolo_v4 as ty
from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet, efficientdet_config
from tmv_tpu_torch.parallel import halo
from torch_port_cases import seeded_variables


class FlaxStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = FlaxConvBN(16, 3)(x, train)
        return FlaxConvBN(32, 3, strides=2)(x, train)


class NHWC(torch.nn.Module):
    """A stage that takes NCHW, run on NHWC images (the sharded forward splits dim 1)."""

    def __init__(self, stage):
        super().__init__()
        self.stage = stage

    def forward(self, x):
        y = self.stage(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        return y.permute(0, 2, 3, 1)


def bridged(flax_module, torch_module, images, seed=0, fix=None):
    """Seeded flax variables (``fix`` rewrites leaves), loaded into ``torch_module``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(flax_module.init, jax.random.key(0), jnp.asarray(images))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    if fix is not None:
        variables = jax.tree_util.tree_map_with_path(lambda p, v: fix(p, v, rng), variables)
    torch_module.load_state_dict(flax_to_state_dict(variables, torch_module), strict=True)
    return variables, torch_module.eval()


def within(got, want, rel):
    """Every output of ``got`` (port, NHWC) within ``rel``·max|ref| (rtol 1e-5) of
    ``want``'s (JAX)."""
    ok = True
    for g, w in zip(sc.flat(got), jax.tree_util.tree_leaves(want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        ok &= bool(np.all(np.abs(g - w) <= 1e-5 * np.abs(w) + rel * np.abs(w).max()))
    return ok


def images(size, batch=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def narrow():
    """``{version: (torch module, JAX heads)}`` for the 1/8-width YOLOv4 and YOLOv3
    at 64 px."""
    x = images(64)
    out = {}
    for version, flax_model, torch_model in (("v4", sc.flax_narrow_v4(), sc.narrow_v4()),
                                             ("v3", sc.flax_narrow_v3(), sc.narrow_v3())):
        variables, net = bridged(flax_model, torch_model, x, seed=1)
        out[version] = (net, jax.jit(flax_model.apply)(variables, jnp.asarray(x)))
    return x, out


@pytest.mark.parametrize("shards", [2, 4])
def test_convbn_stack_matches_jax(shards):
    x = images(16, batch=4)
    flax_model = FlaxStack()
    variables, stack = bridged(flax_model, sc.cases.ConvBNStack(), x, seed=2)
    want = flax_model.apply(variables, jnp.asarray(x))
    got = sc.spatial_forward(stack, x, shards)
    assert within(got, want, 2e-5)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("version", ["v4", "v3"])
def test_narrow_yolo_matches_jax(narrow, version, shards):
    x, models = narrow
    net, want = models[version]
    got = sc.spatial_forward(net, x, shards)
    assert [tuple(g.shape) for g in got] == [(2, 2, 2, 21), (2, 4, 4, 21), (2, 8, 8, 21)]
    assert within(got, want, 2e-5)


def test_zeroed_halos_fail_the_tolerance(narrow, monkeypatch):
    x, models = narrow
    net, want = models["v4"]
    gather = halo.ThreadTransport.all_gather

    def zeroed(self, t):
        parts = gather(self, t)
        return [p if j == self.rank else torch.zeros_like(p) for j, p in enumerate(parts)]

    monkeypatch.setattr(halo.ThreadTransport, "all_gather", zeroed)
    assert not within(sc.spatial_forward(net, x, 2), want, 2e-5)


@pytest.mark.parametrize("size, shards", [(20, 4), (32, 2)])
def test_spp_wide_halo_and_gathered_level_match_jax(size, shards):
    x = np.random.default_rng(size).normal(size=(1, size, size, 12)).astype(np.float32)
    flax_stage = fy.LastLayer(8)
    variables, stage = bridged(flax_stage, ty.LastLayer(12, 8), x, seed=3)
    want = flax_stage.apply(variables, jnp.asarray(x))
    got = sc.spatial_forward(NHWC(stage), x, shards)
    assert within(got, want, 5e-6)
    # the 13-window's plan on shard 1: over 4 shards of 5 rows its halo above (6 rows)
    # takes shard 0's whole share and reaches past it; over 2 shards of 16 rows the
    # shards send their 6 top and bottom rows
    p = halo.plan(1, shards, size, size, ("window", 13, 1, 6))
    assert (p.split, p.up, p.whole) == (True, 6, shards == 4)


def test_pad_sides_of_the_two_families():
    # Darknet's stride-2 conv pads the top: shard 1's halo is the row above its own
    darknet = halo.plan(1, 2, 64, 32, ("window", 3, 2, 1))
    assert (darknet.lo, darknet.hi, darknet.top, darknet.bottom) == (31, 64, 0, 0)
    assert halo.plan(0, 2, 64, 32, ("window", 3, 2, 1)).top == 1
    # TF-SAME on an even height pads the bottom (3x3) or 1 top / 2 bottom (5x5):
    # shard 0's halo comes from below
    same3 = halo.plan(0, 2, 64, 32, ("window", 3, 2, 0))
    assert (same3.lo, same3.hi, same3.top) == (0, 33, 0)
    assert halo.plan(1, 2, 64, 32, ("window", 3, 2, 0)).bottom == 1
    same5 = halo.plan(0, 2, 64, 32, ("window", 5, 2, 1))
    assert (same5.lo, same5.hi, same5.top, same5.down) == (0, 34, 1, 2)


@pytest.fixture(scope="module")
def d0():
    size = 64
    cfg = efficientdet_config("efficientdet-d0", 81, size)
    cfg.fused_dw_eval = False
    flax_model = FlaxEfficientDetNet(config=cfg)
    x = images(size, seed=size)

    def fix(path, leaf, rng):     # fusion weights away from Σw + 1e-4 = 0
        return (rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
                if path[-1].key.startswith("WSM_") else leaf)

    net, _ = build_efficientdet("efficientdet-d0", 81, size, device="cpu")
    variables, net = bridged(flax_model, net, x, seed=size, fix=fix)
    want = jax.jit(lambda v, i: flax_model.apply(v, i, train=False))(variables, jnp.asarray(x))
    return x, net, want


@pytest.mark.parametrize("shards", [2, 4])
def test_d0_matches_jax(d0, shards):
    x, net, want = d0
    got = sc.spatial_forward(net, x, shards)
    assert [g.shape[1] for g in got[1]] == [8, 4, 2, 1, 1]
    assert within(got, want, 1e-5)


def test_thread_board_exchanges_hold_under_contention():
    """More shard threads than cores, a short switch interval: in each of many
    exchanges every shard receives every other shard's tensor of that same exchange
    (the board's two rows are used in turns with one barrier an exchange)."""
    import sys
    import threading

    shards, rounds = 16, 200
    board = halo.ThreadBoard(shards)
    wrong = []

    def run(rank):
        transport = halo.ThreadTransport(board, rank)
        for turn in range(rounds):
            parts = transport.all_gather(torch.tensor([rank, turn]))
            if [p.tolist() for p in parts] != [[j, turn] for j in range(shards)]:
                wrong.append((rank, turn))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not wrong
