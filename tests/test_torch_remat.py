"""``--remat`` (``layers.common.remat_call``) against the direct model, on the CPU.

One float64 train step (``core.train_state.make_train_step``, Adam) with and
without remat, from one ``state_dict`` and one batch, for YOLOv4, YOLOv3 and
ResNetYoloV3 at 64 px, EfficientDet-D0 at 64 px with its ``survival_prob`` of
0.8 (the heads' ``drop_connect`` draws from an explicit generator, which the
recompute must replay), UNet at depth 2, and FaceNet's InceptionResNetV1 at 80
px on 2 triplets through the triplet loss (its head's dropout at 0.2 draws from
an explicit generator outside the recomputed blocks): the loss, every gradient, every
BatchNorm statistic (updated once per step, not again in the recompute), the
parameters after the update and the generator's state afterwards agree within
1e-12 (they come out bit-equal); the ``state_dict`` keys are identical. One
more case runs the Darknet warm-up's masked step (``frozen`` + the output convs
only) under remat. Every model checks that its stages did run through
``torch.utils.checkpoint``.
"""

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from tmv_tpu_torch.cli.train_yolo import HEAD_PREFIXES
from tmv_tpu_torch.core.train_state import TrainState, make_train_step
from tmv_tpu_torch.models.detector_harness import build_yolo_model, freeze_mask, frozen
from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
from tmv_tpu_torch.models.facenet import FaceNetModel, make_triplet_train_step
from tmv_tpu_torch.models.facenet.model import init_weights as facenet_init
from tmv_tpu_torch.models.layers.common import init_weights
from tmv_tpu_torch.models.unet import UNetLogits
from tmv_tpu_torch.models.unet import init_weights as unet_init
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)


def heads_loss(model, batch):
    return sum(torch.mean(torch.square(h)) for h in model(batch["image"])), {}


def d0_loss(generator):
    def loss_fn(model, batch):
        boxes, classes = model(batch["image"], generator=generator)
        return sum(torch.mean(torch.square(h)) for h in boxes + classes), {}
    return loss_fn


def unet_loss(model, batch):
    return torch.mean(torch.square(model(batch["image"]) - 0.5)), {}


def facenet_loss(generator):
    triplet = make_triplet_train_step(0.2, generator)

    def loss_fn(model, batch):
        a, p, n = torch.chunk(batch["image"], 3)
        return triplet(model, {"anchor": a, "positive": p, "negative": n})
    return loss_fn


def build(name, remat):
    if name in ("v4", "v3", "resnet"):
        model, _ = build_yolo_model(name, 2, device="cpu", dtype=torch.float64, remat=remat)
        init_weights(model, 0)
    elif name == "d0":
        model, _ = build_efficientdet("efficientdet-d0", 4, 64, dtype=torch.float64,
                                      device="cpu", remat=remat)
        from tmv_tpu_torch.models.efficientdet.net import init_weights as d0_init

        d0_init(model, 0)
        assert model.config.survival_prob < 1
    elif name == "facenet":
        model = facenet_init(FaceNetModel(16, remat=remat, device="cpu"), 0)
    else:
        model = unet_init(UNetLogits(depth=2, filters_base=4, output_filters=4, remat=remat), 0)
    return model.double()


def step_once(name, remat, mask=None):
    """(model, metrics, grads, generator state) after one step."""
    model = build(name, remat)
    generator = torch.Generator().manual_seed(5)
    loss_fn = {"d0": d0_loss(generator), "facenet": facenet_loss(generator),
               "unet": unet_loss}.get(name, heads_loss)
    size, count = {"unet": (32, 2), "facenet": (80, 6)}.get(name, (64, 2))
    batch = {"image": torch.from_numpy(
        np.random.default_rng(1).uniform(0, 1, (count, size, size, 3)))}
    params = ([p for n, p in model.named_parameters() if mask[n]] if mask is not None
              else model.parameters())
    state = TrainState.create(model, torch.optim.Adam(params, lr=1e-3))
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(*args, **kwargs):
        calls.append(kwargs["use_reentrant"])
        return real(*args, **kwargs)

    torch.utils.checkpoint.checkpoint = spy
    try:
        if mask is None:
            metrics = make_train_step(loss_fn, clip_global_norm=10.0)(state, batch)
        else:
            with frozen(model, mask):
                metrics = make_train_step(loss_fn, shadow_loss=True)(state, batch)
    finally:
        torch.utils.checkpoint.checkpoint = real
    assert calls == ([False] * len(calls)) and bool(calls) == remat
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return model, metrics, grads, generator.get_state()


def assert_same_step(name, mask=None):
    direct, m0, g0, rng0 = step_once(name, False, mask)
    remat, m1, g1, rng1 = step_once(name, True, mask)
    assert list(direct.state_dict()) == list(remat.state_dict())
    for key in m0:
        assert abs(float(m0[key]) - float(m1[key])) <= 1e-12 * max(1.0, abs(float(m0[key]))), key
    assert set(g0) == set(g1) and g0
    for key in g0:
        assert float((g0[key] - g1[key]).abs().max()) <= 1e-12, key
    s0, s1 = direct.state_dict(), remat.state_dict()
    for key in s0:            # parameters after the update, BatchNorm statistics, counters
        assert torch.equal(s0[key], s1[key]) or float(
            (s0[key] - s1[key]).abs().max()) <= 1e-12, key
    tracked = [v for k, v in s0.items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 1 for v in tracked)     # one update per step
    assert torch.equal(rng0, rng1)
    return g0


@pytest.mark.parametrize("name", ["v4", "v3", "resnet", "d0", "unet", "facenet"])
def test_remat_step_equals_the_direct_step(name, one_torch_thread):
    assert_same_step(name)


def test_remat_under_the_darknet_warm_up(one_torch_thread):
    model = build("v3", False)
    mask = freeze_mask(model, HEAD_PREFIXES)
    grads = assert_same_step("v3", mask)
    assert set(grads) == {n for n, trains in mask.items() if trains}
