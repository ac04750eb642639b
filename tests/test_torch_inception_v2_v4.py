"""The port's InceptionResNetV2 and InceptionV4 and the Inception blocks they
share against the JAX package's, on the CPU.

Each case bridges seeded flax variables into the port's module and holds it in
eval mode in float32 within 1e-5·max|ref| and in train mode in float64 within
1e-10·max|ref|, every BatchNorm statistic within 1e-10 of its largest entry
(``torch_port_cases.hold_against_flax``), at full widths: ``InceptionStem``,
``InceptionBlockA/B/C``, ``ReductionA`` with IRv2's and V4's (k, l, m, n),
``ReductionBV4``, IRv2's ``InceptionResNetA2/B2/C2`` and ``ReductionBV2``; each
whole backbone on 6 images (two triplets; dropout rate 0 in train mode) at 112
px, where the C stage runs at 2 × 2 (at 80 px it runs at 1 × 1, and the
train-mode BatchNorms over 6 values per channel amplify rounding until float64
runs of either package part beyond 1e-10 of InceptionV4's output); and the full
bridge tree and ``FaceNetModel`` around each at 80 px in eval mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.models.backbones import inception_modules as jax_modules
from tmv_tpu.models.backbones import inception_resnet_v2 as jax_irv2
from tmv_tpu.models.backbones import inception_v4 as jax_v4
from tmv_tpu.models.facenet import FaceNetModel as JaxFaceNet
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.backbones import inception_modules, inception_resnet_v2, inception_v4
from tmv_tpu_torch.models.facenet import FaceNetModel
from torch_port_cases import hold_against_flax, seeded_variables
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

# the port's torch work on one thread: no OpenMP oversubscription under test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = dict(device="cpu")
BLOCKS = {
    "InceptionStem": (jax_modules.InceptionStem(), lambda: inception_modules.InceptionStem(**CPU),
                      (2, 80, 88, 3)),
    "InceptionBlockA": (jax_modules.InceptionBlockA(),
                        lambda: inception_modules.InceptionBlockA(384, **CPU), (2, 5, 7, 384)),
    "ReductionA V4": (jax_modules.ReductionA(192, 224, 256, 384),
                      lambda: inception_modules.ReductionA(384, 192, 224, 256, 384, **CPU),
                      (2, 5, 7, 384)),
    "InceptionBlockB": (jax_modules.InceptionBlockB(),
                        lambda: inception_modules.InceptionBlockB(1024, **CPU), (2, 7, 9, 1024)),
    "ReductionBV4": (jax_modules.ReductionBV4(),
                     lambda: inception_modules.ReductionBV4(1024, **CPU), (2, 5, 7, 1024)),
    "InceptionBlockC": (jax_modules.InceptionBlockC(),
                        lambda: inception_modules.InceptionBlockC(1536, **CPU), (2, 3, 4, 1536)),
    "InceptionResNetA2": (jax_irv2.InceptionResNetA2(),
                          lambda: inception_resnet_v2.InceptionResNetA2(**CPU), (2, 5, 7, 384)),
    "ReductionA IRv2": (jax_modules.ReductionA(256, 256, 384, 384),
                        lambda: inception_modules.ReductionA(384, 256, 256, 384, 384, **CPU),
                        (2, 5, 7, 384)),
    "InceptionResNetB2": (jax_irv2.InceptionResNetB2(),
                          lambda: inception_resnet_v2.InceptionResNetB2(**CPU), (2, 5, 7, 1152)),
    "ReductionBV2": (jax_irv2.ReductionBV2(), lambda: inception_resnet_v2.ReductionBV2(**CPU),
                     (2, 5, 7, 1152)),
    "InceptionResNetC2": (jax_irv2.InceptionResNetC2(),
                          lambda: inception_resnet_v2.InceptionResNetC2(**CPU), (2, 3, 4, 2144)),
}
WHOLE = {
    "InceptionResNetV2": (jax_irv2.InceptionResNetV2(16, dropout_rate=0.0),
                          lambda: inception_resnet_v2.InceptionResNetV2(16, 0.0, **CPU)),
    "InceptionV4": (jax_v4.InceptionV4(16, dropout_rate=0.0),
                    lambda: inception_v4.InceptionV4(16, 0.0, **CPU)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name):
    flax_module, make, shape = BLOCKS[name]
    hold_against_flax(flax_module, make(), shape)


@pytest.mark.parametrize("name", list(WHOLE))
def test_backbone_matches_flax(name):
    flax_module, make = WHOLE[name]
    hold_against_flax(flax_module, make(), (6, 112, 112, 3), seed=1)


@pytest.mark.parametrize("name", list(WHOLE))
def test_bridge_maps_the_full_facenet_tree(name):
    flax_model = JaxFaceNet(512, backbone=name)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 80, 80, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(2)))
    model = FaceNetModel(512, backbone=name, **CPU)
    state = flax_to_state_dict(variables, model)         # the model's keys exactly
    assert model.backbone_name == f"{name}_0"
    model.load_state_dict(state, strict=True)
    x = np.random.default_rng(4).uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: flax_model.apply(v, a))(variables, x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
