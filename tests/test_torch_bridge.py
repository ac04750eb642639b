"""The flax → state_dict bridge (tmv_tpu_torch.convert.flax_bridge).

The full-width YoloV4(classes_num=80) tree comes from ``jax.eval_shape`` (no
FLOPs), is filled from a seed and bridged into the port's module with
``load_state_dict(strict=True)``: every flax leaf is consumed exactly once, with
its shape and value carried over (conv HWIO → OIHW).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict, state_dict_to_flax
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from torch_port_cases import flax_leaf_count, seeded_variables


@pytest.fixture(scope="module")
def yolo_tree():
    shapes = jax.eval_shape(FlaxYoloV4(classes_num=80).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    return jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(0)))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_full_width_yolov4_bridges_every_leaf_once(yolo_tree):
    model = YoloV4(classes_num=80)
    state = flax_to_state_dict(yolo_tree, model)
    model.load_state_dict(state, strict=True)

    bn_counters = [k for k in state if k.endswith("num_batches_tracked")]
    assert len(state) - len(bn_counters) == flax_leaf_count(yolo_tree)
    torch_state = model.state_dict()
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}
    for collection in ("params", "batch_stats"):
        for path, value in _flat(yolo_tree[collection]):
            key = ".".join(path[:-1] + (leaf_names[path[-1]],))
            want = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value
            np.testing.assert_array_equal(torch_state[key].numpy(), want)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(v.size for _, v in _flat(yolo_tree["params"]))
    assert model.ConvBN_0.BatchNorm_0.eps == 1e-3
    assert model.ConvBN_0.BatchNorm_0.momentum == pytest.approx(0.01)


def test_full_width_yolov4_round_trips_through_the_state_dict(yolo_tree):
    """flax → state_dict → flax (``state_dict_to_flax``) is the identity on the JAX
    model's own tree, leaf by leaf; the BatchNorm step counters are dropped, and a key
    without a flax counterpart is refused."""
    state = flax_to_state_dict(yolo_tree)
    back = state_dict_to_flax(state)
    want, got = dict(_flat(yolo_tree)), dict(_flat(back))
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == np.float32 and got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value)
    with pytest.raises(KeyError, match="no flax counterpart"):
        state_dict_to_flax({**state, "ConvBN_0.Mystery_0.weight": torch.zeros(3)})


def test_bridge_refuses_unknown_and_mismatched_leaves(yolo_tree):
    extra = {"params": {**yolo_tree["params"], "Mystery_0": {"w": np.zeros(3)}},
             "batch_stats": yolo_tree["batch_stats"]}
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict(extra)
    with pytest.raises(KeyError, match="collections"):
        flax_to_state_dict({**yolo_tree, "quant": {}})
    no_stats = {"params": yolo_tree["params"], "batch_stats": {}}
    with pytest.raises(KeyError, match="lacks running_mean"):
        flax_to_state_dict(no_stats)
    with pytest.raises(ValueError, match="flax shape"):
        flax_to_state_dict(yolo_tree, YoloV4(classes_num=2))
    short = {"params": {k: v for k, v in yolo_tree["params"].items() if k != "DarknetConv_2"},
             "batch_stats": yolo_tree["batch_stats"]}
    with pytest.raises(KeyError, match="key mismatch"):
        flax_to_state_dict(short, YoloV4(classes_num=80))


class _FlaxDwDense(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(6, (3, 3), feature_group_count=6, padding="SAME")(x)
        return fnn.Dense(5)(x.mean(axis=(1, 2)))


class _TorchDwDense(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(6, 6, 3, padding=1, groups=6)
        self.Dense_0 = torch.nn.Linear(6, 5)

    def forward(self, x):
        return self.Dense_0(self.Conv_0(x.permute(0, 3, 1, 2)).mean(dim=(2, 3)))


def test_depthwise_and_dense_mappings(rng):
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    flax_model = _FlaxDwDense()
    variables = jax.tree.map(np.asarray, flax_model.init(jax.random.key(1), jnp.asarray(x)))
    net = _TorchDwDense()
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
