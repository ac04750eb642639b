"""The port's MoCo pretraining against the JAX package's, on the CPU.

- The train step on the three-scale stand-in of ``tests/test_moco_distill.py``
  (``torch_port_cases.tiny_flax_detector`` and its torch twin) at 32 px, B = 2,
  a queue of 16, SGD(0.05, momentum 0.9), a momentum warm-up of 2 steps so
  that the second step's decay is 0.5: two JAX steps equal one JAX step,
  ``moco_state_from_flax`` + ``optax_sgd_state_dict``, then one port step. The
  loss within 1e-6 (relative), the query and key weights and BatchNorm
  statistics within 1e-6 of each tensor's largest entry, the queue within 1e-6
  and the pointer exactly (float32 on both sides: one step of rounding).
- ``push_queue`` wraps like JAX's for pointers and counts up to n = K.
- ``flatten_normalize`` and ``moco_info_nce_loss`` on heads that come out of a
  ``channels_last`` conv equal JAX's on the same NHWC arrays within 1e-6.
- ``two_crop_batches`` gives JAX's arrays bit for bit for a seed.
- ``init_moco_state``: the generator's queue has unit rows, JAX's queue is
  taken as is, the key tower is a frozen copy; a checkpoint holds and restores
  the key tower, the queue and the pointer beside the query state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tmv_tpu.cli.train_moco import two_crop_batches as jax_two_crop_batches
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.models import moco as jax_moco
from tmv_tpu.ops.losses import moco_info_nce_loss as jax_info_nce
from tmv_tpu_torch.cli.train_moco import two_crop_batches
from tmv_tpu_torch.convert.flax_bridge import (
    flax_to_state_dict, moco_state_from_flax, optax_sgd_state_dict,
)
from tmv_tpu_torch.core.checkpoint import CheckpointManager
from tmv_tpu_torch.core.train_state import TrainState
from tmv_tpu_torch.models.moco import (
    flatten_normalize, init_moco_state, make_moco_train_step, push_queue,
)
from tmv_tpu_torch.ops.losses import moco_info_nce_loss
from torch_port_cases import seeded_variables, tiny_flax_detector, tiny_torch_detector
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE, BATCH, QUEUE, OUT = 32, 2, 16, 6


def crops(rng):
    return {k: rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
            for k in ("query", "key")}


def close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def test_moco_step_matches_two_jax_steps():
    rng = np.random.default_rng(0)
    model = tiny_flax_detector(OUT)
    x0 = jnp.zeros((BATCH, SIZE, SIZE, 3))
    shapes = jax.eval_shape(model.init, jax.random.key(0), x0)
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    dim = sum(int(np.prod(h.shape[1:])) for h in model.apply(variables, x0))
    extra = jax_moco.init_moco_state(variables, QUEUE, dim, jax.random.key(1))
    tx = optax.sgd(0.05, momentum=0.9)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx, extra=extra)
    step = jax.jit(jax_moco.make_moco_train_step(model, tx, momentum_warmup_steps=2))
    b1, b2 = crops(rng), crops(rng)
    s1, _ = step(state, {k: jnp.asarray(v) for k, v in b1.items()}, jax.random.key(0))
    s2, m2 = step(s1, {k: jnp.asarray(v) for k, v in b2.items()}, jax.random.key(1))

    net = tiny_torch_detector(OUT)
    net.load_state_dict(flax_to_state_dict({"params": s1.params, "batch_stats": s1.batch_stats},
                                           net), strict=True)
    net = net.to(memory_format=torch.channels_last)
    opt = torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9)
    opt.load_state_dict(optax_sgd_state_dict(s1.opt_state, net, opt))
    moco = moco_state_from_flax(s1.extra, tiny_torch_detector(OUT))
    assert moco.queue_ptr == BATCH
    tstate = TrainState.create(net, opt, extra=moco)
    tstate.step = int(s1.step)
    metrics = make_moco_train_step(momentum_warmup_steps=2)(
        tstate, {k: torch.from_numpy(v) for k, v in b2.items()})

    assert tstate.step == int(s2.step) == 2
    assert abs(float(metrics["loss"]) - float(m2["loss"])) <= 1e-6 * abs(float(m2["loss"]))
    for got_model, tree in ((net, {"params": s2.params, "batch_stats": s2.batch_stats}),
                            (moco.key_model, {"params": s2.extra.key_params,
                                              "batch_stats": s2.extra.key_batch_stats})):
        want = flax_to_state_dict(tree, got_model)
        got = got_model.state_dict()
        for name, w in want.items():
            if w.is_floating_point():
                close(got[name].numpy(), w.numpy(), 1e-6, name)
    # the key tower really blended (decay 0.5): it differs from the query tower
    assert not torch.equal(moco.key_model.Conv_0.weight, net.Conv_0.weight)
    close(moco.queue.numpy(), np.asarray(s2.extra.queue), 1e-6, "queue")
    assert moco.queue_ptr == int(s2.extra.queue_ptr) == 2 * BATCH


@pytest.mark.parametrize("ptr,n", [(0, 1), (6, 3), (7, 2), (0, 8), (5, 8)])
def test_push_queue_wraps_like_jax(ptr, n):
    rng = np.random.default_rng(ptr * 10 + n)
    queue = rng.normal(size=(8, 4)).astype(np.float32)
    items = rng.normal(size=(n, 4)).astype(np.float32)
    want_q, want_p = jax_moco.push_queue(jnp.asarray(queue), jnp.asarray(ptr, jnp.int32),
                                         jnp.asarray(items))
    got_q, got_p = push_queue(torch.from_numpy(queue.copy()), ptr, torch.from_numpy(items))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_p == int(want_p)


def test_flatten_normalize_and_info_nce_on_channels_last_heads():
    """Heads that a ``channels_last`` conv writes are NHWC views whose memory is
    not NCHW-contiguous: they must flatten in JAX's NHWC order."""
    gen = torch.Generator().manual_seed(3)
    convs = [torch.nn.Conv2d(4, 6, 1) for _ in range(3)]
    heads = []
    for conv, hw in zip(convs, (2, 4, 8)):
        x = torch.rand((3, 4, hw, hw), generator=gen).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            heads.append(conv(x).permute(0, 2, 3, 1))
    keys = [h.flip(0) * 0.5 + 0.1 for h in heads]
    queue = torch.nn.functional.normalize(torch.rand((5, 6 * 84), generator=gen), dim=1)
    got = flatten_normalize(heads).numpy()
    want = np.asarray(jax_moco.flatten_normalize([jnp.asarray(h.numpy()) for h in heads]))
    close(got, want, 1e-6, "flatten_normalize")
    got_loss = float(moco_info_nce_loss(heads, keys, queue, 0.07))
    want_loss = float(jax_info_nce([jnp.asarray(h.numpy()) for h in heads],
                                   [jnp.asarray(k.numpy()) for k in keys],
                                   jnp.asarray(queue.numpy()), 0.07))
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)


def test_two_crop_batches_equal_jax_bit_for_bit(tmp_path):
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate(((40, 56), (48, 48), (30, 64))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}.{'jpg' if i % 2 else 'png'}")
    ours = two_crop_batches(str(tmp_path), 3, 32, seed=4)
    theirs = jax_two_crop_batches(str(tmp_path), 3, 32, seed=4)
    for _ in range(2):
        got, want = next(ours), next(theirs)
        for k in ("query", "key"):
            assert got[k].dtype == np.float32 and got[k].shape == (3, 32, 32, 3)
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_moco_state_init_and_checkpoint_round_trip(tmp_path):
    torch.manual_seed(0)
    net = tiny_torch_detector(OUT)
    gen = torch.Generator().manual_seed(1)
    moco = init_moco_state(net, QUEUE, 126, generator=gen)
    assert moco.queue.shape == (QUEUE, 126) and moco.queue_ptr == 0
    np.testing.assert_allclose(moco.queue.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    for (name, p), k in zip(net.named_parameters(), moco.key_model.parameters()):
        assert torch.equal(p, k) and p.data_ptr() != k.data_ptr() and not k.requires_grad, name
    jax_queue = np.random.default_rng(2).uniform(size=(QUEUE, 126)).astype(np.float32)
    np.testing.assert_array_equal(
        init_moco_state(net, QUEUE, 126, queue=jax_queue).queue.numpy(), jax_queue)
    with pytest.raises(ValueError, match="queue of shape"):
        init_moco_state(net, QUEUE, 127, queue=jax_queue)

    state = TrainState.create(net, torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9),
                              extra=moco)
    step = make_moco_train_step(momentum_warmup_steps=2)
    rng = np.random.default_rng(6)
    for _ in range(3):
        step(state, {k: torch.from_numpy(v) for k, v in crops(rng).items()})
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state)
    fresh_net = tiny_torch_detector(OUT)
    fresh = TrainState.create(fresh_net, torch.optim.SGD(fresh_net.parameters(), lr=0.05,
                                                         momentum=0.9),
                              extra=init_moco_state(fresh_net, QUEUE, 126, generator=gen))
    mgr.restore(fresh)
    mgr.close()
    assert fresh.step == 3 and fresh.extra.queue_ptr == moco.queue_ptr == 3 * BATCH % QUEUE
    assert torch.equal(fresh.extra.queue, moco.queue)
    for a, b in zip(fresh.extra.key_model.state_dict().values(),
                    moco.key_model.state_dict().values()):
        assert torch.equal(a, b)
    bufs = [s["momentum_buffer"] for s in fresh.optimizer.state_dict()["state"].values()]
    assert len(bufs) == len(list(net.parameters()))
    # a checkpoint with the MoCo state does not restore into a state without one
    plain = TrainState.create(fresh_net, torch.optim.SGD(fresh_net.parameters(), lr=0.05))
    with pytest.raises(KeyError, match="extra state"):
        CheckpointManager(str(tmp_path / "ckpt")).restore(plain)
