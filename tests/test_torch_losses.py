"""The port's YOLO training loss and train-mode model against the JAX package.

On the CPU, float32, the same numpy inputs to both sides:

- ``sigmoid_cross_entropy``: values and gradients w.r.t. the logits (logit 0
  included), rtol 1e-6 / atol 1e-7.
- ``iou_xyxy(iou_type="ciou")`` (and ``"iou"``/``"diou"``): values and gradients
  w.r.t. the predicted box on random, zero-area, inverted and coincident boxes,
  compared where the JAX function is finite: rtol 1e-5, atol 1e-6.
- ``yolo_loss``: value (rtol 1e-5) and gradients w.r.t. the raw heads (atol
  1e-5·max|grad|) on YOLOv4 head shapes at 64 × 64, 3 classes, B = 4 (images
  with 0 GT, 1 GT, and more GTs in one scale than the 100-box capacity), for
  ``iou_type`` iou and ciou.
- ``ConvBN`` in train mode: output of each of 3 steps (atol 1e-5·max|ref|) and
  the running mean and variance after them (rtol 1e-5, atol 1e-6) against flax,
  which blends in the *biased* batch variance.
- The whole ``YoloV4(classes_num=3)`` at 64 × 64, B = 2, on bridged seeded
  weights, in train mode: the loss of ``make_yolo_loss_fn(iou_type="ciou")``,
  every parameter's gradient and the BatchNorm statistics after the step,
  against JAX. Train-mode BatchNorm over the 8 values per channel of the 2 × 2
  maps makes this gradient ill-conditioned: in float32 the port and JAX each
  miss the float64 gradient by up to ~35% of a leaf's largest entry (and their
  heads by ~0.5%). So the case runs twice: in float64 on both sides (JAX under
  ``jax.enable_x64``), where it holds the arithmetic — loss rtol 1e-9, each
  gradient within 1e-6·max|grad| of its leaf, statistics within 1e-7 — and in
  float32, the training dtype, where it holds the loss to rtol 5e-4 and each
  leaf's gradient to a relative L2 error of 0.25 (worst seen 0.08).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.data.yolo_targets import make_yolo_targets as jax_targets
from tmv_tpu.models.detector_harness import make_yolo_loss_fn as jax_loss_fn
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu.ops.iou import iou_xyxy as jax_iou_xyxy
from tmv_tpu.ops.losses import sigmoid_cross_entropy as jax_sce
from tmv_tpu.ops.yolo import yolo_loss as jax_yolo_loss
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.detector_harness import make_yolo_loss_fn
from tmv_tpu_torch.models.layers.common import ConvBN
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from tmv_tpu_torch.ops.iou import iou_xyxy
from tmv_tpu_torch.ops.losses import sigmoid_cross_entropy
from tmv_tpu_torch.ops.yolo import yolo_loss
from torch_port_cases import seeded_variables

ANCHORS = np.array([[[32, 28], [40, 44], [60, 50]],
                    [[14, 18], [20, 16], [24, 30]],
                    [[4, 6], [8, 7], [10, 12]]], np.float32)


def torch_grad(fn, *arrays):
    """(value, gradient w.r.t. the first array) of a torch function."""
    x = torch.tensor(arrays[0], requires_grad=True)
    out = fn(x, *(torch.from_numpy(a) for a in arrays[1:]))
    out.sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def test_sigmoid_cross_entropy_and_gradient(rng):
    logits = rng.normal(0, 4, (64,)).astype(np.float32)
    logits[:3] = [0.0, 30.0, -30.0]
    labels = rng.uniform(0, 1, (64,)).astype(np.float32)
    labels[:8] = np.round(labels[:8])
    value, grad = torch_grad(lambda x, z: sigmoid_cross_entropy(z, x), logits, labels)
    want, want_grad = jax.value_and_grad(lambda x: jnp.sum(jax_sce(labels, x)))(logits)
    np.testing.assert_allclose(value.sum(), want, rtol=1e-6)
    np.testing.assert_allclose(value, np.asarray(jax_sce(labels, logits)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=1e-6, atol=1e-7)


def box_pairs(rng, n=64):
    """Predicted and GT xyxy boxes: random, zero-area, inverted, coincident,
    nested and disjoint pairs."""
    def boxes(m):
        xy = rng.uniform(0, 1, (m, 2))
        return np.concatenate([xy, xy + rng.uniform(0.01, 0.5, (m, 2))], -1)

    pred, gt = boxes(n), boxes(n)
    gt[0] = pred[0]                                     # coincident
    pred[1, 2] = pred[1, 0]                             # zero width
    pred[2, [0, 2]] = pred[2, [2, 0]]                   # inverted x
    gt[3] = pred[3] + [0.01, 0.01, -0.01, -0.01]        # nested
    gt[4] = pred[4] + 2.0                               # disjoint
    pred[5, 3] = pred[5, 1]                             # zero height (atan of inf)
    return pred.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("iou_type", ["iou", "diou", "ciou"])
def test_iou_xyxy_values_and_gradients(rng, iou_type):
    pred, gt = box_pairs(rng)
    value, grad = torch_grad(lambda p, g: iou_xyxy(p, g, iou_type), pred, gt)
    want = np.asarray(jax_iou_xyxy(pred, gt, iou_type))
    want_grad = np.asarray(jax.grad(lambda p: jnp.sum(jax_iou_xyxy(p, gt, iou_type)))(pred))
    ok = np.isfinite(want)
    assert ok.sum() >= 60
    np.testing.assert_array_equal(np.isfinite(value), ok)
    np.testing.assert_allclose(value[ok], want[ok], rtol=1e-5, atol=1e-6)
    rows = np.isfinite(want_grad).all(-1)
    assert rows.sum() >= 58
    np.testing.assert_allclose(grad[rows], want_grad[rows], rtol=1e-5, atol=1e-6)


def loss_case(rng, batch=4, size=64, classes=3):
    """Raw heads and targets at YOLOv4's head shapes: image 0 has no GT, image 1
    one GT, image 2 150 GTs in the finest scale (past the capacity of 100)."""
    shapes = [(size // s, size // s) for s in (32, 16, 8)]
    heads, targets = [], []
    for h, w in shapes:
        heads.append(rng.normal(0, 1.5, (batch, h, w, 3 * (5 + classes))).astype(np.float32))
        t = np.zeros((batch, h, w, 3, 5 + classes), np.float32)
        obj = rng.uniform(size=(batch, h, w, 3)) < 0.15
        obj[0] = False
        obj[1] = False
        if h == size // 8:
            obj[1, 2, 3, 1] = True
            flat = obj[2].reshape(-1)
            flat[:] = False
            flat[rng.permutation(flat.size)[:150]] = True
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        t[..., 0] = (gx[..., None] + rng.uniform(0, 1, obj.shape)) / w
        t[..., 1] = (gy[..., None] + rng.uniform(0, 1, obj.shape)) / h
        t[..., 2:4] = rng.uniform(0.02, 0.6, obj.shape + (2,))
        t[..., 4] = 1.0
        t[..., 5:] = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, obj.shape)]
        targets.append(t * obj[..., None])
    return heads, targets


@pytest.mark.parametrize("iou_type", ["iou", "ciou"])
def test_yolo_loss_and_head_gradients(rng, iou_type):
    heads, targets = loss_case(rng)
    assert (targets[2][2, ..., 4] > 0).sum() == 150

    def jax_fn(hs):
        return jax_yolo_loss([jnp.asarray(t) for t in targets], hs, (64, 64), ANCHORS,
                             iou_type=iou_type)

    want, want_grads = jax.jit(jax.value_and_grad(jax_fn))([jnp.asarray(h) for h in heads])
    xs = [torch.tensor(h, requires_grad=True) for h in heads]
    loss = yolo_loss([torch.from_numpy(t) for t in targets], xs, (64, 64), ANCHORS,
                     iou_type=iou_type)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for x, g in zip(xs, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_yolo_loss_of_bf16_heads_is_float32(rng):
    heads, targets = loss_case(rng, batch=3)
    t = [torch.from_numpy(a) for a in targets]
    half = yolo_loss(t, [torch.from_numpy(h).bfloat16() for h in heads], (64, 64), ANCHORS)
    full = yolo_loss(t, [torch.from_numpy(h).bfloat16().float() for h in heads], (64, 64),
                     ANCHORS)
    assert half.dtype == torch.float32 and float(half) == float(full)


def test_convbn_train_mode_matches_flax(rng):
    flax_mod = FlaxConvBN(8, 3, act="mish")
    xs = [rng.normal(0.3, 1.2, (2, 9, 9, 5)).astype(np.float32) for _ in range(3)]
    shapes = jax.eval_shape(flax_mod.init, jax.random.key(0), jnp.zeros((1, 9, 9, 5)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    mod = ConvBN(5, 8, 3, act="mish")
    mod.load_state_dict(flax_to_state_dict(variables, mod), strict=True)
    mod.train()
    params, stats = variables["params"], variables["batch_stats"]
    for x in xs:
        want, mutated = flax_mod.apply({"params": params, "batch_stats": stats}, x, train=True,
                                       mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    bn = mod.BatchNorm_0
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["BatchNorm_0"]["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["BatchNorm_0"]["var"],
                               rtol=1e-5, atol=1e-6)
    # torch's own update (unbiased variance) would miss by n/(n-1) = 162/161
    assert int(bn.num_batches_tracked) == 3


def yolo_batch(rng, size=64, batch=2, classes=3):
    """Images and JAX-made targets from random boxes."""
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    targets = []
    for _ in range(batch):
        x1 = rng.uniform(0, size - 24, 6)
        y1 = rng.uniform(0, size - 24, 6)
        boxes = np.stack([x1, y1, x1 + rng.uniform(4, 24, 6), y1 + rng.uniform(4, 24, 6)], -1)
        out = jax_targets(jnp.asarray(boxes, jnp.float32),
                          jnp.asarray(rng.integers(0, classes, 6), jnp.int32),
                          jnp.ones(6, bool), ANCHORS, (size, size), classes)
        targets.append([np.asarray(t) for t in out])
    return images, [np.stack(t) for t in zip(*targets)]


@pytest.fixture(scope="module")
def yolov4_case():
    """Seeded float32 weights of ``YoloV4(classes_num=3)`` and a 64 × 64 batch of
    2, made once for both dtypes (the parameter shapes do not depend on it)."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(FlaxYoloV4(classes_num=3).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    return (variables, *yolo_batch(rng))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_whole_yolov4_loss_and_gradients_match_jax(yolov4_case, dtype):
    variables, images, targets = yolov4_case
    with jax.enable_x64(dtype == "float64"):
        flax_model = FlaxYoloV4(classes_num=3, dtype=jnp.dtype(dtype))
        cast = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        loss_fn = jax_loss_fn(flax_model, (64, 64), ANCHORS, iou_type="ciou")
        batch = {"image": jnp.asarray(images, dtype),
                 "targets": tuple(jnp.asarray(t, dtype) for t in targets)}
        (want, (new_stats, _)), want_grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, cast["batch_stats"], batch, None), has_aux=True))(
            cast["params"])
        flat = {"params": jax.tree.map(np.asarray, want_grads),
                "batch_stats": jax.tree.map(np.asarray, new_stats)}
        want = float(want)

    tdtype = getattr(torch, dtype)
    net = YoloV4(classes_num=3, dtype=tdtype)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    net = net.to(tdtype).train()
    loss, _ = make_yolo_loss_fn((64, 64), ANCHORS, iou_type="ciou")(
        net, {"image": torch.from_numpy(images).to(tdtype),
              "targets": tuple(torch.from_numpy(t) for t in targets)})
    loss.backward()
    assert loss.dtype == tdtype
    exact = dtype == "float64"
    np.testing.assert_allclose(loss.item(), want, rtol=1e-9 if exact else 5e-4)

    want_state = {k: v.double() for k, v in flax_to_state_dict(flat, net).items()}
    named = dict(net.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(want_grads))
    for name, p in named.items():
        g, w = p.grad.double(), want_state[name]
        if exact:
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max()), name
        else:
            assert float((g - w).norm() / w.norm()) <= 0.25, name
    for name, b in net.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            w = want_state[name]
            tol = 1e-7 if exact else 1e-4
            assert float((b.double() - w).abs().max()) <= tol * float(w.abs().max()), name
