"""The port's training core against the JAX package's, on the CPU.

- ``make_train_step`` on a small ConvBN + conv model bridged from flax, 5 steps
  with the shadow loss (crossing its ``step > 1`` gate), a global-norm clip
  that bites, weight EMA with BatchNorm-statistics EMA and ``accum_steps = 2``:
  the reported and raw losses and the gradient norm of every step, then the
  parameters, BatchNorm statistics and both EMAs, against
  ``tmv_tpu.core.train_state.make_train_step`` with ``optax.adam`` (rtol 1e-5,
  atol 1e-6).
- ``optax_adam_state_dict``: JAX takes two steps, the state is bridged, and one
  port step equals JAX's third (rtol 1e-5, atol 1e-6).
- The schedules (``shadow_loss_decay`` exactly, ``cosine_lr_schedule`` rtol 1e-6),
  the callbacks' sequences on one loss series (exactly), ``set_learning_rate``.
- ``CheckpointManager``: round trip, ``max_to_keep``, the asynchronous save
  drained, the de-dup of a re-save, ``restore_weights``, and a resume that
  continues bit for bit as the uninterrupted run.
- ``ops/map_eval.py``: the port's copy equals the JAX package's on random and
  tied data, every variant.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmv_tpu.core import callbacks as jax_callbacks
from tmv_tpu.core import schedules as jax_schedules
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_train_step as jax_make_train_step
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu.models.layers.common import DarknetConv as FlaxDarknetConv
from tmv_tpu.ops import map_eval as jax_map_eval
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict, optax_adam_state_dict
from tmv_tpu_torch.core import callbacks, schedules
from tmv_tpu_torch.core.checkpoint import CheckpointManager
from tmv_tpu_torch.core.metrics import MetricsLogger, StepTimer, profiler_trace
from tmv_tpu_torch.core.train_state import TrainState, make_train_step
from tmv_tpu_torch.models.layers.common import ConvBN, DarknetConv
from tmv_tpu_torch.ops import map_eval
from torch_port_cases import seeded_variables

TOL = dict(rtol=1e-5, atol=1e-6)


class FlaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = FlaxConvBN(6, 3, act="leaky")(x, train)
        return FlaxDarknetConv(4, 1)(x)


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 6, 3, act="leaky")
        self.DarknetConv_0 = DarknetConv(6, 4, 1)

    def forward(self, x):
        return self.DarknetConv_0(self.ConvBN_0(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def jax_loss(params, batch_stats, batch, rng):
    out, mutated = FlaxTiny().apply({"params": params, "batch_stats": batch_stats},
                                    batch["image"], train=True, mutable=["batch_stats"])
    return jnp.mean(jnp.square(out - batch["target"])), (mutated["batch_stats"], {})


def port_loss(model, batch):
    return torch.mean(torch.square(model(batch["image"]) - batch["target"])), {}


@pytest.fixture()
def tiny(rng):
    shapes = jax.eval_shape(FlaxTiny().init, jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    batches = [{"image": rng.normal(0, 1, (4, 8, 8, 3)).astype(np.float32),
                "target": rng.normal(0, 1, (4, 8, 8, 4)).astype(np.float32)} for _ in range(5)]
    return variables, batches


def port_model(variables):
    model = Tiny()
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_state_close(tensors, params, batch_stats):
    """``tensors`` (torch names → tensors) equal the bridged flax trees."""
    want = flax_to_state_dict(jax.tree.map(np.asarray, {"params": params,
                                                        "batch_stats": batch_stats}))
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(tensors[key].detach().numpy(), value.numpy(), **TOL,
                                       err_msg=key)


def test_train_step_matches_jax(tiny):
    variables, batches = tiny
    kw = dict(clip_global_norm=0.5, shadow_loss=True, ema_decay=0.9, accum_steps=2)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2)
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                  ema_decay=0.9, ema_batch_stats=True)
    jstep = jax.jit(jax_make_train_step(jax_loss, tx, **kw))
    model = port_model(variables)
    state = TrainState.create(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                              ema_decay=0.9, ema_batch_stats=True)
    step = make_train_step(port_loss, **kw)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(i))
        m = step(state, to_torch(batch))
        for key in ("loss", "raw_loss", "gnorm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL, err_msg=key)
        assert float(jm["gnorm"]) > 0.5         # the clip bites
    assert state.step == int(jstate.step) == 5
    np.testing.assert_allclose(float(state.shadow_loss), float(jstate.shadow_loss), **TOL)
    assert_state_close(model.state_dict(), jstate.params, jstate.batch_stats)
    assert_state_close({**state.ema_params, **state.ema_batch_stats}, jstate.ema_params,
                       jstate.ema_batch_stats)


def test_adam_state_bridge_continues_jax(tiny):
    variables, batches = tiny
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=3e-3)
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    jstep = jax.jit(jax_make_train_step(jax_loss, tx))
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[i].items()},
                          jax.random.key(i))
    model = port_model(jax.tree.map(np.asarray, {"params": jstate.params,
                                                 "batch_stats": jstate.batch_stats}))
    optimizer = torch.optim.Adam(model.parameters(), lr=1.0)
    optimizer.load_state_dict(optax_adam_state_dict(jstate.opt_state, model, optimizer))
    assert optimizer.param_groups[0]["lr"] == pytest.approx(3e-3)
    state = TrainState.create(model, optimizer)
    state.step = 2
    make_train_step(port_loss)(state, to_torch(batches[2]))
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batches[2].items()},
                      jax.random.key(2))
    assert_state_close(model.state_dict(), jstate.params, jstate.batch_stats)


def test_schedules_match_jax():
    steps = np.arange(0, 3000, 7)
    got = np.array([schedules.shadow_loss_decay(s) for s in steps])
    np.testing.assert_array_equal(got, np.asarray(jax_schedules.shadow_loss_decay(steps)))
    assert got.dtype == np.float32
    want = jax_schedules.cosine_lr_schedule(0.08, 0.008, 100, 1000)
    got = schedules.cosine_lr_schedule(0.08, 0.008, 100, 1000)
    for s in (0, 1, 50, 99, 100, 101, 500, 999, 1000):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
    assert schedules.scaled_lr(0.08, 16) == jax_schedules.scaled_lr(0.08, 16)


def test_callbacks_sequences_match_jax():
    series = [5.0, 4.0, 4.5, 4.2, 4.1, 4.0, 4.3, 3.9, 3.95, 4.0, 4.1, 4.2, 4.3, 3.0, 3.1, 3.2]
    for kw in (dict(patience=2), dict(patience=3, min_delta=0.05), dict(mode="max", patience=2)):
        a, b = callbacks.EarlyStopping(**kw), jax_callbacks.EarlyStopping(**kw)
        assert [a.update(v) for v in series] == [b.update(v) for v in series]
    for kw in (dict(factor=0.1, patience=2, min_lr=1e-6, base_lr=1e-3),
               dict(factor=0.5, patience=1, min_lr=2e-4, base_lr=1e-3)):
        a, b = callbacks.ReduceLROnPlateau(**kw), jax_callbacks.ReduceLROnPlateau(**kw)
        assert [a.update(v) for v in series] == [b.update(v) for v in series]
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2))], lr=1e-3)
    callbacks.set_learning_rate(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] == 2.5e-4
    shutdown = callbacks.GracefulShutdown()
    try:
        assert not shutdown.requested
    finally:
        shutdown.uninstall()


def run_steps(model, batches, state=None):
    state = state or TrainState.create(model, torch.optim.Adam(model.parameters(), lr=1e-2))
    step = make_train_step(port_loss, shadow_loss=True)
    losses = [float(step(state, to_torch(b))["loss"]) for b in batches]
    return state, losses


def test_checkpoint_round_trip_keep_async_and_resume(tiny, tmp_path):
    variables, batches = tiny
    full, full_losses = run_steps(port_model(variables), batches)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    part, part_losses = run_steps(port_model(variables), batches[:1])
    mgr.save(1, part, wait=False)
    part, more = run_steps(part.model, batches[1:3], part)
    mgr.save(3, part, wait=False)
    mgr.save(3, part, wait=False)                      # a re-save at one step is skipped
    mgr.wait_until_finished()
    assert mgr.all_steps() == [1, 3] and mgr.latest_step() == 3
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]

    fresh = TrainState.create(port_model(variables),
                              torch.optim.Adam(port_model(variables).parameters(), lr=1e-2))
    fresh.optimizer = torch.optim.Adam(fresh.model.parameters(), lr=1e-2)
    resumed = CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert resumed.step == 3
    resumed, rest = run_steps(resumed.model, batches[3:], resumed)
    assert part_losses + more + rest == full_losses
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert float(resumed.shadow_loss) == float(full.shadow_loss)

    mgr.save(5, resumed)
    mgr.save(6, resumed)
    assert mgr.all_steps() == [5, 6]                    # max_to_keep = 2
    weights_only = port_model(variables)
    assert mgr.restore_weights(weights_only, step=5) == 5
    for a, b in zip(weights_only.state_dict().values(), resumed.model.state_dict().values()):
        assert torch.equal(a, b)
    mgr.close()
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.latest_step() is None and empty.restore_weights(weights_only) is None


def test_metrics_logger_timer_and_profiler(tmp_path):
    timer = StepTimer(batch_size=4)
    assert timer.tick() == {}
    out = timer.tick()
    assert out["images_per_sec"] > 0 and timer.total_steps == 2
    logger = MetricsLogger(str(tmp_path / "m.jsonl"))
    logger.log(3, {"loss": torch.tensor(1.5), "note": "x"})
    logger.close()
    assert json.loads((tmp_path / "m.jsonl").read_text()) == {"step": 3, "loss": 1.5,
                                                              "note": "x"}
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).add_(1)
    assert prof is not None and (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with profiler_trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None


def map_records(rng, images=12, classes=4, tied=False):
    data = []
    for i in range(images):
        gt = [[*b, c] for b, c in zip(box_rows(rng, 5), rng.integers(0, classes, 5))]
        pred = [[*b, c, s] for b, c, s in zip(
            box_rows(rng, 8), rng.integers(0, classes, 8),
            np.round(rng.uniform(0, 1, 8) * 4) / 4 if tied else rng.uniform(0, 1, 8))]
        pred += [[*g[:4], g[4], 0.5] for g in gt[:3]]
        data.append({"image_path": f"{i}.jpg", "groud_truth": gt, "prediction": pred})
    return data


def box_rows(rng, n):
    xy = rng.uniform(0, 0.7, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (n, 2))], -1).tolist()


@pytest.mark.parametrize("tied", [False, True])
def test_map_eval_copy_matches_jax(rng, tied):
    data = map_records(rng, tied=tied)
    for variant in ("reference", "voc"):
        for thresh in (0.3, 0.5):
            assert (map_eval.get_map(data, 4, thresh, variant)
                    == jax_map_eval.get_map(data, 4, thresh, variant))
    assert map_eval.get_map_coco(data, 4) == jax_map_eval.get_map_coco(data, 4)
    one = data[0]
    assert (map_eval.get_map_one(one["groud_truth"], one["prediction"], 4)
            == jax_map_eval.get_map_one(one["groud_truth"], one["prediction"], 4))
