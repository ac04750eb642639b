"""``models/efficientdet/demo.py`` against ``tmv_tpu/models/efficientdet/demo.py``.

``DemoModel``'s five levels of class and box heads (float32, within
1e-5·max|JAX|) and ``make_demo_loss_fn``'s loss (float64, within 1e-10 relative) and
its gradients (float64, within 1e-9·max|JAX| per parameter) on bridged seeded flax
weights and seeded targets, at 64 px (the last pools run on 1 x 1 maps, where SAME
pads with -inf) and at 96 x 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.efficientdet.demo import DemoModel as FlaxDemoModel
from tmv_tpu.models.efficientdet.demo import make_demo_loss_fn as jax_make_demo_loss_fn
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.efficientdet.demo import DemoModel, make_demo_loss_fn
from torch_port_cases import by_torch_name, seeded_variables

CLASSES = 4


def case(size, seed):
    """(flax variables, the bridged module, images, per-level targets) at ``size``."""
    rng = np.random.default_rng(seed)
    flax_model = FlaxDemoModel(num_classes=CLASSES)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, *size, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    net = DemoModel(num_classes=CLASSES)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    images = rng.uniform(0, 1, (2, *size, 3)).astype(np.float32)
    heads = jax.eval_shape(flax_model.apply, shapes, jnp.asarray(images))
    masks = [rng.uniform(size=b.shape[:-1]) < 0.1 for b in heads[1]]
    batch = {"image": images,
             "classes": [(rng.uniform(size=c.shape) < 0.05) * m[..., None] * 1.0
                         for c, m in zip(heads[0], masks)],
             "boxes": [rng.normal(0, 0.5, b.shape) * m[..., None] for b, m in zip(heads[1], masks)],
             "masks": masks}
    return flax_model, variables, net, batch


@pytest.mark.parametrize("size", [(64, 64), (96, 128)])
def test_demo_heads_match_flax(size):
    flax_model, variables, net, batch = case(size, 0)
    want = jax.jit(flax_model.apply)(variables, jnp.asarray(batch["image"]))
    with torch.no_grad():
        got = net(torch.from_numpy(batch["image"]))
    for g_level, w_level in zip(got, want):
        assert len(g_level) == len(w_level) == 5
        for g, w in zip(g_level, w_level):
            w = np.asarray(w)
            assert g.shape == w.shape and g.shape[3] == 9
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("size", [(64, 64), (96, 128)])
def test_demo_loss_and_gradients_match_jax(size):
    flax_model, variables, net, batch = case(size, 1)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        jbatch = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64 if a.dtype != bool else bool),
                              batch)
        loss_fn = jax_make_demo_loss_fn(flax_model.clone(dtype=jnp.float64))
        (want, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(p, {}, b, None), has_aux=True))(params, jbatch)
        want, grads = float(want), by_torch_name(grads)
    net = net.double()
    tbatch = {k: (torch.from_numpy(v).double() if k == "image" else
                  [torch.from_numpy(np.asarray(a)) for a in v]) for k, v in batch.items()}
    tbatch["classes"] = [t.double() for t in tbatch["classes"]]
    tbatch["boxes"] = [t.double() for t in tbatch["boxes"]]
    loss, aux = make_demo_loss_fn()(net, tbatch)
    loss.backward()
    assert aux == {} and want > 0
    assert abs(loss.item() - want) <= 1e-10 * abs(want)
    params = dict(net.named_parameters())
    assert set(params) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g, rtol=0,
                                   atol=1e-9 * np.abs(g).max(), err_msg=name)
