"""The port's RepVGG against the JAX package's, on the CPU.

- RepVGG-B2g4 (FaceNet's ``--backbone RepVGG``, embedding 16) at 64 px, train
  branches and deploy model, bridged from seeded flax variables: eval mode in
  float32 within 1e-5·max|ref|, train mode in float64 within 1e-10·max|ref| with
  every BatchNorm statistic within 1e-10 (``hold_against_flax``); the bridge's
  full tree with the named ``conv``, ``bn``, ``rbr_identity`` and ``dense``, and
  ``rbr_reparam``; ``FaceNetModel(backbone="RepVGG")`` on it.
- ``repvgg_convert_params`` on seeded train variables (non-trivial BatchNorm
  statistics) equal to JAX's within 1e-6 of each tensor's largest entry, for
  B2g4 (grouped convs: the one-hot identity kernel ``[i, i % (C/g), 1, 1]``) and
  the JAX test's small net; the deploy model on the converted state equal to the
  train model in eval mode at JAX's test tolerance (rtol 1e-3, atol 1e-4), also
  after train-mode forwards moved the statistics.
- ``stage_plan`` and the parameter shapes of all 13 named variants equal JAX's
  (built on the meta device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.backbones import repvgg as jax_repvgg
from tmv_tpu.models.facenet import FaceNetModel as JaxFaceNet
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.backbones import repvgg
from tmv_tpu_torch.models.facenet import FaceNetModel
from torch_port_cases import hold_against_flax, seeded_variables
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

# the port's torch work on one thread: no OpenMP oversubscription under test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(num_blocks=(1, 1, 1, 1), num_classes=10, width_multiplier=(0.25, 0.25, 0.25, 0.5))


@pytest.mark.parametrize("deploy", [False, True])
def test_b2g4_matches_flax(deploy):
    hold_against_flax(jax_repvgg.get_repvgg_by_name("RepVGG-B2g4", 16, deploy=deploy),
                      repvgg.get_repvgg_by_name("RepVGG-B2g4", 16, deploy=deploy, device="cpu"),
                      (4, 64, 64, 3), seed=1)


def test_facenet_repvgg_bridge_and_embeddings():
    flax_model = JaxFaceNet(512, backbone="RepVGG")
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(2)))
    model = FaceNetModel(512, backbone="RepVGG", device="cpu")
    assert model.backbone_name == "RepVGG_0"
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: flax_model.apply(v, a))(variables, x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def flax_train_variables(module, size, seed):
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, size, size, 3)))
    return jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(seed)))


@pytest.mark.parametrize("case", ["RepVGG-B2g4", "small"])
def test_convert_params_equal_jax_and_deploy_equals_train(case):
    if case == "small":
        jax_train, size = jax_repvgg.RepVGG(**SMALL), 32
        train, deploy = (repvgg.RepVGG(**SMALL, deploy=d, device="cpu") for d in (False, True))
    else:
        jax_train, size = jax_repvgg.get_repvgg_by_name(case, 16), 64
        train, deploy = (repvgg.get_repvgg_by_name(case, 16, deploy=d, device="cpu")
                         for d in (False, True))
    variables = flax_train_variables(jax_train, size, seed=3)
    train.load_state_dict(flax_to_state_dict(variables, train), strict=True)
    want = flax_to_state_dict(jax_repvgg.repvgg_convert_params(variables, jax_train), deploy)
    got = repvgg.repvgg_convert_params(train)
    assert set(got) == set(want) == set(deploy.state_dict())
    for key in want:
        scale = float(want[key].abs().max())
        assert float((got[key] - want[key]).abs().max()) <= 1e-6 * scale, key

    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 3, size, size))
                         .astype(np.float32))
    with torch.no_grad():
        train.train()(x)           # train-mode forwards move the running statistics
        train(x * 0.5 + 0.25)
        deploy.load_state_dict(repvgg.repvgg_convert_params(train), strict=True)
        y_train = train.eval()(x).numpy()
        y_deploy = deploy.eval()(x).numpy()
    np.testing.assert_allclose(y_deploy, y_train, rtol=1e-3, atol=1e-4)


def shapes_by_torch_name(tree):
    """{torch key: shape} of a flax ``eval_shape`` tree (kernels transposed)."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(k.key) for k in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        out[".".join(keys[:-1] + [names[keys[-1]]])] = tuple(shape)
    return out


@pytest.mark.parametrize("name", sorted(jax_repvgg._VARIANTS))
def test_named_variants_match_jax(name):
    jax_model = jax_repvgg.get_repvgg_by_name(name, 7)
    model = repvgg.get_repvgg_by_name(name, 7, device="meta")
    assert model.stage_plan() == jax_model.stage_plan()
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    want = {**shapes_by_torch_name(shapes["params"]),
            **shapes_by_torch_name(shapes["batch_stats"])}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
