"""``FullyShardedDataParallel`` and ``DataParallel`` against JAX's, on gloo CPU ranks.

- The ConvBN stack (two ConvBN, seeded; the flax stack given the same weights
  through the bridge), batch 8 made with numpy: two SGD steps under the port's
  ``DataParallel`` and ``FullyShardedDataParallel`` over 2 ranks against
  ``tmv_tpu.parallel.train.DataParallel`` and ``FullyShardedDataParallel`` on a
  2-device slice of the conftest's virtual CPU mesh: parameters and running
  statistics within 1e-5·max|ref| of each leaf.
- FSDP: its step equals DP's, its sharded forward the plain one; each rank stores
  1/R of the large leaves (and of their Adam moments and EMA mirrors) and the
  replicated small ones whole; a checkpoint written under FSDP loads into a plain
  model and equals DP's; it round-trips through a plain template and trains on
  resharded; a plain checkpoint resumes under FSDP.
- ``fsdp_spec`` against JAX's, and the torch dim it picks is the flax dim's for every
  leaf of a YOLOv3 and a D0 through the bridge.
- The D0 @64 B4 step with the global ``num_positives`` under DP against one process
  (``tests/dp_equiv_cases.py``'s YOLO tolerances); a rank-local one must fail them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import torch_parallel_cases as cases
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_train_step as jax_train_step
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu.parallel import fsdp as jax_fsdp
from tmv_tpu.parallel.train import DataParallel as JaxDataParallel
from tmv_tpu_torch.convert.flax_bridge import _leaves, _map_leaf, flax_to_state_dict
from tmv_tpu_torch.convert.flax_bridge import state_dict_to_flax
from tmv_tpu_torch.parallel.fsdp import fsdp_spec, flax_shape, shard_dim

PATHS = ("d0",)


class FlaxStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = FlaxConvBN(16, 3)(x, train)
        return FlaxConvBN(32, 3, strides=2)(x, train)


def jax_convbn(wrapper):
    """Two SGD 0.1 steps of the flax stack under a JAX wrapper, from the port's seed-0
    weights → the port's ``state_dict`` layout."""
    model = FlaxStack()
    variables = state_dict_to_flax(cases.init_convbn().state_dict())
    tx = optax.sgd(0.1)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)

    def loss_fn(params, batch_stats, batch, rng):
        y, new = model.apply({"params": params, "batch_stats": batch_stats}, batch["image"],
                             train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.square(y - batch["target"])), (new["batch_stats"], {})

    raw = jax_train_step(loss_fn, tx)
    step = wrapper.wrap_step(raw) if isinstance(wrapper, JaxDataParallel) \
        else wrapper.wrap_step(raw, state)
    state = wrapper.put_state(state)
    for batch in cases.convbn_batches():
        state, _ = step(state, wrapper.put_batch(batch), wrapper.put_rng(jax.random.key(0)))
    return flax_to_state_dict({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(state.batch_stats)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and here meanwhile: the one-process D0 step and the JAX
    wrappers' ConvBN steps."""
    root = tmp_path_factory.mktemp("fsdp_ranks")
    ranks = cases.Ranks("fsdp_worker", 2, root, str(root), PATHS, ("d0_local_positives",))
    try:
        with cases.threads(2):
            refs = {name: cases.run_case(name) for name in PATHS}
        devices = jax.devices()[:2]
        refs["jax_dp"] = jax_convbn(JaxDataParallel(2))
        refs["jax_fsdp"] = jax_convbn(jax_fsdp.FullyShardedDataParallel(devices=devices,
                                                                        min_size=32))
    finally:
        results = ranks.results()
    return refs, results, root


def assert_leaves_close(got, ref, scale=1e-5):
    """Every float leaf of ``ref`` within ``scale``·max|leaf| of ``got``'s."""
    for key, value in cases.floats(ref).items():
        want = np.asarray(value, np.float64)
        np.testing.assert_allclose(np.asarray(got[key], np.float64), want, rtol=0,
                                   atol=scale * max(np.abs(want).max(), 1e-30), err_msg=key)


@pytest.mark.parametrize("port, jax_ref", [("convbn_dp", "jax_dp"), ("convbn_fsdp", "jax_dp"),
                                           ("convbn_fsdp", "jax_fsdp")])
def test_convbn_steps_equal_jax_wrappers(runs, port, jax_ref):
    """Two SGD steps: parameters and running statistics within 1e-5·max|ref|."""
    refs, results, _ = runs
    jax_state = {k: torch.as_tensor(np.asarray(v)) for k, v in refs[jax_ref].items()}
    for result in results:
        assert_leaves_close(result[port][-1]["model"], jax_state)


def test_fsdp_step_equals_dp_step(runs):
    """Loss equal to rel 1e-6; the state within 1e-5·max|leaf| (the reduce-scatter and
    the all-reduce add the same two values)."""
    for result in runs[1]:
        dp, fs = result["convbn_dp"][-1], result["convbn_fsdp"][-1]
        assert fs["metrics"]["loss"] == pytest.approx(dp["metrics"]["loss"], rel=1e-6)
        assert_leaves_close(fs["model"], dp["model"])


def test_fsdp_forward_equals_the_plain_forward(runs):
    """``wrap_forward``: the sharded stack in eval mode on each rank's rows, gathered in
    batch order, equals the plain forward of the whole batch (rtol 1e-5, atol 1e-6)."""
    for result in runs[1]:
        want, got = result["forward"]
        assert got.shape == want.shape == (8, 8, 8, 32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_fsdp_stores_a_rank_share_of_the_large_leaves(runs):
    """Under Adam with the EMA: every leaf the rule shards holds 1/R of its elements
    on each rank along the rule's dim, its two moments and EMA mirror alike; the
    replicated leaves (the first BatchNorm's, 16 < ``min_size`` 32) are whole; the
    rank's storage is at most 1/R of the whole plus the replicated leaves."""
    for result in runs[1]:
        whole = local = replicated = 0
        for name, info in result["storage"].items():
            numel, here, dim = info["param"]
            expected = None if "ConvBN_0.BatchNorm_0" in name else 0
            assert dim == expected, name
            assert here == (numel if dim is None else numel // 2), name
            for kept in list(info["moments"].values()) + [info["ema"]]:
                assert kept == info["param"], name
            whole += numel
            local += here
            replicated += numel if dim is None else 0
        assert local <= whole / 2 + replicated and replicated == 32
        assert result["shadow_loss"].shape == ()


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_fsdp_checkpoint_loads_plain_and_equals_dps(runs):
    """After two steps of SGD with momentum, the EMA and the shadow loss, rank 0's
    file (one written per run) in the single-device format: it loads strictly into a
    plain module; its weights, momentum buffers (one parameter group, module order),
    EMA and shadow loss equal DP's within 1e-5·max|leaf|."""
    root = runs[2]
    dp, fs = _load(root / "dp" / "2.pt"), _load(root / "fsdp" / "2.pt")
    assert sorted(p.name for p in (root / "fsdp").iterdir()) == ["2.pt"]
    plain = cases.ConvBNStack()
    plain.load_state_dict(fs["model"], strict=True)
    assert_leaves_close(fs["model"], dp["model"])
    assert_leaves_close(fs["ema_params"], dp["ema_params"])
    assert len(fs["optimizer"]["param_groups"]) == 1
    assert fs["optimizer"]["param_groups"][0]["params"] == list(range(6))
    for i, moments in dp["optimizer"]["state"].items():
        assert_leaves_close(fs["optimizer"]["state"][i], moments)
    assert fs["step"] == dp["step"] == 2
    assert float(fs["shadow_loss"]) == pytest.approx(float(dp["shadow_loss"]), rel=1e-6)
    optimizer = torch.optim.SGD(plain.parameters(), lr=0.05, momentum=0.9)
    optimizer.load_state_dict(fs["optimizer"])


def test_fsdp_checkpoint_round_trips_and_trains_on(runs):
    """FSDP's live state gathered equals its file exactly; restored into a plain
    template and resharded, the third step runs (finite loss, step 3) and equals the
    third step of DP resumed from DP's file within 1e-5·max|leaf|."""
    root = runs[2]
    written = _load(root / "fsdp" / "2.pt")
    for result in runs[1]:
        for key, value in result["fsdp_live"]["model"].items():
            assert torch.equal(value, written["model"][key]), key
        again = result["fsdp_roundtrip"]
        assert again["step"] == 3 and np.isfinite(again["metrics"]["loss"])
        assert_leaves_close(again["model"], result["dp_resumed_dp"]["model"])


def test_plain_checkpoint_resumes_under_fsdp(runs):
    """DP's file (the single-device format) restored into a plain state and put under
    FSDP continues at step 3 as DP continues it (state within 1e-5·max|leaf|)."""
    for result in runs[1]:
        fs, dp = result["dp_resumed_fsdp"], result["dp_resumed_dp"]
        assert fs["step"] == dp["step"] == 3
        assert fs["metrics"]["loss"] == pytest.approx(dp["metrics"]["loss"], rel=1e-6)
        assert_leaves_close(fs["model"], dp["model"])


@pytest.mark.parametrize("shape, axis, min_size", [
    ((3, 3, 16, 32), 8, 1), ((3, 3, 32, 32), 8, 1), ((3, 3, 64, 32), 8, 1), ((64,), 8, 1),
    ((), 8, 1024), ((3, 3, 3, 6), 8, 1), ((16, 16), 8, 1024), ((32, 32), 4, 1024),
    ((3, 3, 3, 6), 2, 1), ((5, 7, 9), 2, 1), ((6, 4, 6), 2, 1), ((1024,), 4, 1024),
    ((1023,), 4, 1), ((2, 2, 2, 2), 2, 16), ((3, 3, 256, 512), 4, 1024)])
def test_fsdp_spec_is_jaxs(shape, axis, min_size):
    """Largest divisible dim, ties to the last, replicated under ``min_size`` or where
    no dim divides: ranks 0-4, axis sizes 2/4/8."""
    spec = tuple(jax_fsdp.fsdp_spec(shape, axis, min_size=min_size))
    want = spec.index("data") if "data" in spec else None
    assert fsdp_spec(shape, axis, min_size) == want


@pytest.mark.parametrize("family", ["yolo_v3", "d0"])
def test_torch_dim_is_the_flax_dim_of_every_leaf(family):
    """Every parameter leaf of the flax tree, axis sizes 2 and 4: the port's chosen
    torch dim is the dim JAX's rule picks in the flax shape, carried through the
    bridge's layout."""
    if family == "yolo_v3":
        from tmv_tpu_torch.models.detector_harness import build_yolo_model

        model, _ = build_yolo_model("v3", 2, 3, device="meta")
    else:
        from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet

        model, _ = build_efficientdet("efficientdet-d0", 3, 64, device="meta")
    params = dict(model.named_parameters())
    tree = state_dict_to_flax({k: torch.zeros(v.shape) for k, v in params.items()})["params"]
    count = 0
    for (path, leaf), axis in ((p, a) for p in _leaves(tree) for a in (2, 4)):
        key, transform = _map_leaf("params", path)
        t = params[key]
        assert flax_shape(t) == leaf.shape, key
        spec = tuple(jax_fsdp.fsdp_spec(leaf.shape, axis))
        got = shard_dim(t, axis)
        if "data" not in spec:
            assert got is None, key
        else:
            flax_dim = spec.index("data")
            # the same logical axis: a one at index 1 of the flax dim, carried into the
            # torch layout by the bridge's transform, lands at index 1 of the torch dim
            marker = np.zeros(leaf.shape, np.float32)
            index = [0] * len(leaf.shape)
            index[flax_dim] = 1
            marker[tuple(index)] = 1.0
            moved = marker if transform is None else transform(marker)
            assert moved.shape == tuple(t.shape), key
            assert np.argwhere(moved == 1.0)[0][got] == 1, key
        count += 1
    assert count == 2 * len(params)



@pytest.mark.parametrize("name", PATHS + ("d0_local_positives",))
def test_ranks_hold_one_state(runs, name):
    cases.check_ranks_hold_one_state(runs[1], name)


def test_d0_dp_step_equals_the_one_process_step(runs):
    cases.check_dp_step_equals_the_one_process_step(runs[0]["d0"][-1], runs[1][0]["d0"][-1])


def test_rank_local_positives_fail_the_tolerance(runs):
    """With ``num_positives`` rank-local the D0 step is out of tolerance."""
    cases.check_control_fails_the_tolerance(runs[0]["d0"][-1],
                                            runs[1][0]["d0_local_positives"][-1])
