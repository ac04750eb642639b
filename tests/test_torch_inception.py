"""The port's InceptionResNetV1 and the shared Inception blocks against the JAX
package's, on the CPU.

Every case bridges seeded flax variables (``flax_to_state_dict``) into the port's
module and holds it on a seeded input: in eval mode in float32 within
1e-5·max|ref|, and in train mode in float64 within 1e-10·max|ref| with every
BatchNorm statistic after the forward within 1e-10 of its largest entry
(``torch_port_cases.hold_against_flax``), at full widths:

- ``BasicConv2D`` with the SAME ``(1, 7)`` and ``(7, 1)`` kernels on a
  non-square map, ``Conv2DLinear`` VALID at stride 2;
- ``avg_pool_same`` (border pixels divided by all 9 taps, flax's
  ``count_include_pad``) and ``max_pool_valid`` against flax's pools;
- ``StemV1``, ``InceptionResNetA/B/C``, ``ReductionA(192, 192, 256, 384)`` and
  ``ReductionBV1``;
- the whole ``InceptionResNetV1`` at 80 px on 6 images, the two triplets of
  one small train step (dropout rate 0 in train mode; with 2 images each C
  block's train-mode BatchNorm over 2 values per channel at 1 × 1 amplifies
  rounding block by block, and float64 runs of either package part far beyond
  1e-10), its full bridge tree, the same tree under ``remat=True``, and ``FaceNetModel``
  around it (NHWC in, unit-norm embeddings);
- dropout: fed flax's own mask, the port's ``apply_dropout`` equals flax's
  ``nn.Dropout``; without a generator train-mode dropout raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.backbones import inception_modules as jax_modules
from tmv_tpu.models.backbones import inception_resnet_v1 as jax_irv1
from tmv_tpu.models.facenet import FaceNetModel as JaxFaceNet
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.backbones import inception_modules, inception_resnet_v1
from tmv_tpu_torch.models.facenet import FaceNetModel
from torch_port_cases import flax_leaf_count, hold_against_flax, seeded_variables
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

# the port's torch work on one thread: no OpenMP oversubscription under test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = dict(device="cpu")
BLOCKS = {
    "BasicConv2D (1, 7)": (jax_modules.BasicConv2D(24, (1, 7)),
                           lambda: inception_modules.BasicConv2D(16, 24, (1, 7), **CPU),
                           (2, 9, 13, 16)),
    "BasicConv2D (7, 1)": (jax_modules.BasicConv2D(24, (7, 1)),
                           lambda: inception_modules.BasicConv2D(16, 24, (7, 1), **CPU),
                           (2, 9, 13, 16)),
    "Conv2DLinear VALID s2": (jax_modules.Conv2DLinear(24, 3, 2, "VALID"),
                              lambda: inception_modules.Conv2DLinear(16, 24, 3, 2, "VALID",
                                                                     **CPU),
                              (2, 11, 14, 16)),
    "StemV1": (jax_irv1.StemV1(), lambda: inception_resnet_v1.StemV1(**CPU), (2, 80, 96, 3)),
    "InceptionResNetA": (jax_irv1.InceptionResNetA(),
                         lambda: inception_resnet_v1.InceptionResNetA(**CPU), (2, 7, 9, 256)),
    "ReductionA": (jax_modules.ReductionA(192, 192, 256, 384),
                   lambda: inception_modules.ReductionA(256, 192, 192, 256, 384, **CPU),
                   (2, 7, 9, 256)),
    "InceptionResNetB": (jax_irv1.InceptionResNetB(),
                         lambda: inception_resnet_v1.InceptionResNetB(**CPU), (2, 5, 7, 896)),
    "ReductionBV1": (jax_irv1.ReductionBV1(), lambda: inception_resnet_v1.ReductionBV1(**CPU),
                     (2, 5, 7, 896)),
    "InceptionResNetC": (jax_irv1.InceptionResNetC(),
                         lambda: inception_resnet_v1.InceptionResNetC(**CPU), (2, 3, 4, 1792)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name):
    flax_module, make, shape = BLOCKS[name]
    hold_against_flax(flax_module, make(), shape)


@pytest.mark.parametrize("shape", [(2, 6, 9, 5), (1, 3, 3, 2)])
def test_pools_match_flax_at_the_border(shape):
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(jax_modules.avg_pool_same(jnp.asarray(x)))
    got = inception_modules.avg_pool_same(t).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the corner's window holds 4 pixels and 5 zero pads: divided by 9, not 4
    np.testing.assert_allclose(got[:, 0, 0], x[:, :2, :2].sum((1, 2)) / 9, atol=1e-6)
    if min(shape[1:3]) >= 3:
        want = np.asarray(jax_modules.max_pool_valid(jnp.asarray(x)))
        got = inception_modules.max_pool_valid(t).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


def test_inception_resnet_v1_matches_flax():
    variables = hold_against_flax(jax_irv1.InceptionResNetV1(16, dropout_rate=0.0),
                                  inception_resnet_v1.InceptionResNetV1(16, 0.0, **CPU),
                                  (6, 80, 80, 3), seed=1)
    assert flax_leaf_count(variables) == 510 + 254


def test_bridge_maps_the_full_facenet_tree_with_and_without_remat():
    flax_model = JaxFaceNet(512)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 80, 80, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(2)))
    x = np.random.default_rng(4).uniform(0, 1, (3, 80, 80, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: flax_model.apply(v, a))(variables, x))
    for remat in (False, True):
        model = FaceNetModel(512, remat=remat, **CPU)
        state = flax_to_state_dict(variables, model)      # every leaf, the model's keys exactly
        assert set(state) == set(model.state_dict())
        assert model.backbone_name == "InceptionResNetV1_0"
        model.load_state_dict(state, strict=True)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_dropout_equals_flax_given_its_mask():
    x = np.random.default_rng(5).uniform(0.5, 1.5, (4, 64)).astype(np.float32)
    want = np.asarray(fnn.Dropout(0.2, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.key(3)}))
    keep = torch.from_numpy(want != 0)       # x > 0, so flax's zeros are its dropped entries
    assert 0 < int(keep.sum()) < keep.numel()
    got = inception_resnet_v1.apply_dropout(torch.from_numpy(x), keep, 0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7)
    t = torch.from_numpy(x)
    assert inception_resnet_v1.dropout(t, 0.2, training=False) is t
    assert inception_resnet_v1.dropout(t, 0.0, training=True) is t
    drawn = inception_resnet_v1.dropout(t, 0.2, True, torch.Generator().manual_seed(0))
    kept = drawn != 0
    assert torch.allclose(drawn[kept], t[kept] / 0.8)
    with pytest.raises(ValueError, match="Generator"):
        inception_resnet_v1.dropout(t, 0.2, training=True)
