"""The port's EfficientDet-D0 training slice against the JAX package, on the CPU.

The same numpy inputs go to both sides:

- ``focal_loss`` (values and gradients w.r.t. the logits), ``box_loss`` (a
  positive's coordinate that encodes to exactly 0 drops out of the mask, as in
  JAX) and ``class_focal_loss`` (a level without positives adds 0): rtol 1e-6.
- ``l2_regularization`` on the bridged D0 tree (64 px, full width): the sum in
  float64 within 1e-12 relative, and its leaves exactly flax's ``kernel`` /
  ``depthwise_kernel`` leaves (no BatchNorm scale, no bias, no ``WSM``).
- ``Anchors.generate_targets`` over a batch with a duplicate GT, an all-padded
  row and a GT at IoU exactly 0.5 with an anchor: masks and one-hot classes
  exactly equal, encoded boxes within 1e-6.
- The whole D0 loss and gradients (``make_efficientdet_loss_fn``, 64 px, B = 2,
  ``survival_prob`` 1.0) from the same init and batch: in float64 on both sides
  (JAX under ``jax.enable_x64``) each gradient within 1e-6 of its leaf's
  largest entry and the loss within 1e-9 relative; in float32 the loss within
  1e-5 relative of the float64 one (the two packages' float32 losses are
  farther apart than that).
  Both with automl's focal sum and with ``reference_focal_reduction``.
- One ``make_train_step`` with SGD on the cosine schedule, the clip and the
  weight EMA, three steps across the warmup, against ``optax.sgd(schedule,
  momentum=0.9)`` (BatchNorm buffers included, rtol 1e-5, atol 1e-6); the
  line-search step against JAX's, with an initial lr that must shrink; and
  ``optax_sgd_state_dict``: JAX takes two steps, the port the third.
- ``drop_connect`` fed JAX's uniform draws gives JAX's output exactly.
- The yxyx GIoU and CIoU, values and gradients w.r.t. both boxes, against
  ``jax.grad`` through ``_ciou_v``'s custom VJP.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmv_tpu.core.schedules import cosine_lr_schedule as jax_cosine
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_line_search_train_step as jax_line_search
from tmv_tpu.core.train_state import make_train_step as jax_make_train_step
from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.efficientdet.heads import init_class_prior_bias
from tmv_tpu.models.efficientdet.net import make_efficientdet_loss_fn as jax_d0_loss_fn
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu.models.layers.common import DarknetConv as FlaxDarknetConv
from tmv_tpu.ops import losses as jax_losses
from tmv_tpu.ops.anchors import Anchors as JaxAnchors
from tmv_tpu.ops.iou import iou_yxyx as jax_iou_yxyx
from tmv_tpu.ops.regularizers import drop_connect as jax_drop_connect
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict, optax_sgd_state_dict
from tmv_tpu_torch.core.schedules import cosine_lr_schedule
from tmv_tpu_torch.core.train_state import (
    TrainState, make_line_search_train_step, make_train_step,
)
from tmv_tpu_torch.models.efficientdet.harness import efficientdet_config
from tmv_tpu_torch.models.efficientdet.heads import drop_connect
from tmv_tpu_torch.models.efficientdet.net import EfficientDetNet, make_efficientdet_loss_fn
from tmv_tpu_torch.models.layers.common import ConvBN, DarknetConv
from tmv_tpu_torch.ops import losses
from tmv_tpu_torch.ops.anchors import Anchors
from tmv_tpu_torch.ops.iou import iou_yxyx
from torch_port_cases import one_torch_thread, seeded_variables

SIZE = 64
CLASSES = 5                       # 4 names + background
TOL = dict(rtol=1e-5, atol=1e-6)


def d0_config(survival_prob=1.0):
    cfg = efficientdet_config("efficientdet-d0", CLASSES, SIZE)
    cfg.fused_dw_eval = False
    cfg.survival_prob = survival_prob
    return cfg


def anchor_pair(cfg):
    args = (cfg.min_level, cfg.max_level, (SIZE, SIZE), cfg.num_scales, cfg.aspect_ratios,
            cfg.anchor_scale)
    return Anchors(*args), JaxAnchors(*args)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ------------------------------------------------------------------- losses
def test_focal_box_and_class_focal_losses_match_jax(rng):
    shape = (2, 4, 4, 9, CLASSES)
    logits = rng.normal(0, 3, shape).astype(np.float32)
    logits.reshape(-1)[:7] = 0.0
    labels = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    want = jax_losses.focal_loss(jnp.asarray(labels), jnp.asarray(logits), 3.0, 0.25, 1.5, 0.1)
    want_grad = jax.grad(lambda x: jnp.sum(jax_losses.focal_loss(
        jnp.asarray(labels), x, 3.0, 0.25, 1.5)))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = losses.focal_loss(torch.from_numpy(labels), x, 3.0, 0.25, 1.5, 0.1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    losses.focal_loss(torch.from_numpy(labels), x, 3.0, 0.25, 1.5).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)

    targets = rng.normal(0, 0.3, (2, 4, 4, 9, 4)).astype(np.float32)
    targets[:, :2] = 0.0                            # negatives
    targets[1, 3, 3, 0, 1] = 0.0                    # a positive's coordinate at exactly 0
    outputs = rng.normal(0, 0.3, targets.shape).astype(np.float32)
    want = jax_losses.box_loss(jnp.asarray(targets), jnp.asarray(outputs), 7.0)
    got = losses.box_loss(torch.from_numpy(targets), torch.from_numpy(outputs), 7.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    moved = outputs.copy()
    moved[1, 3, 3, 0, 1] += 5.0                     # masked out: the loss does not see it
    assert float(losses.box_loss(torch.from_numpy(targets), torch.from_numpy(moved), 7.0)) \
        == float(got)

    levels = [(2, 4, 4, 9), (2, 2, 2, 9), (2, 1, 1, 9)]
    masks = [rng.uniform(size=s + (1,)) < 0.2 for s in levels]
    masks[2][:] = False                             # a level without positives
    cls_t = [(rng.uniform(size=s + (CLASSES,)) < 0.2).astype(np.float32) for s in levels]
    cls_o = [rng.normal(0, 2, s + (CLASSES,)).astype(np.float32) for s in levels]
    want = jax_losses.class_focal_loss([jnp.asarray(a) for a in cls_t],
                                       [jnp.asarray(a) for a in cls_o],
                                       [jnp.asarray(a) for a in masks], 0.25, 1.5)
    got = losses.class_focal_loss([torch.from_numpy(a) for a in cls_t],
                                  [torch.from_numpy(a) for a in cls_o],
                                  [torch.from_numpy(a) for a in masks], 0.25, 1.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def d0_case():
    return make_d0_case()


def make_d0_case():
    """Seeded float32 variables of D0 at 64 px (5 classes, class prior bias) and
    a batch of 2 with its JAX targets."""
    rng = np.random.default_rng(3)
    cfg = d0_config()
    shapes = jax.eval_shape(lambda: FlaxEfficientDetNet(config=cfg).init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    variables["params"] = jax.tree.map(np.asarray, init_class_prior_bias(variables["params"]))
    images = rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    boxes = np.zeros((2, 6, 4), np.float32)
    boxes[0, :3] = [[4, 6, 40, 36], [20, 24, 60, 62], [4, 6, 40, 36]]
    boxes[1, :2] = [[10, 2, 50, 30], [30, 30, 63, 58]]
    classes = np.array([[1, 3, 2, 0, 0, 0], [4, 1, 0, 0, 0, 0]], np.int32)
    valid = classes > 0
    _, janchors = anchor_pair(cfg)
    targets = jax.vmap(lambda b, c, v: janchors.generate_targets(b, c, CLASSES, valid=v))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    targets = jax.tree.map(np.asarray, targets)
    assert sum(int(m.sum()) for m in targets[2]) > 0
    return cfg, variables, images, targets


def kernel_leaf_names(variables, net):
    """The torch names the bridge gives flax's ``kernel`` / ``depthwise_kernel``
    leaves: every such leaf set to 1, everything else to 0."""
    def mark(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        hit = any(n in ("kernel", "weight", "depthwise_kernel") for n in names)
        return np.full(leaf.shape, 1.0 if hit else 0.0, np.float32)

    marked = jax.tree_util.tree_map_with_path(mark, variables)
    return {k for k, v in flax_to_state_dict(marked, net).items() if v.numel() and v.all()}


def test_l2_regularization_matches_flax_leaves(d0_case):
    cfg, variables, _, _ = d0_case
    net = EfficientDetNet(cfg, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    names = {id(p): n for n, p in net.named_parameters()}
    selected = {names[id(w)] for w in losses.regularized_weights(net)}
    assert selected == kernel_leaf_names(variables, net)
    assert not any(n.endswith("bias") or ".WSM_" in n or "BatchNorm" in n or ".bn" in n
                   for n in selected)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        want = float(jax_losses.l2_regularization(params, 4e-5))
    got = float(losses.l2_regularization(net.to(torch.float64), 4e-5))
    assert abs(got - want) <= 1e-12 * abs(want)


# ------------------------------------------------------------------ targets
def test_generate_targets_matches_jax(rng):
    cfg = d0_config()
    anchors, janchors = anchor_pair(cfg)
    boxes = np.zeros((3, 8, 4), np.float32)
    classes = np.zeros((3, 8), np.int32)
    valid = np.zeros((3, 8), bool)
    ys, xs = (np.sort(rng.uniform(0, SIZE, (5, 2)), axis=1) for _ in range(2))
    boxes[0, :5] = np.stack([ys[:, 0], xs[:, 0], ys[:, 1], xs[:, 1]], -1)
    boxes[0, 5] = boxes[0, 1]                       # a duplicate GT: the first wins
    classes[0, :6] = [1, 2, 3, 4, 1, 3]
    valid[0, :6] = True
    # row 1: all padded; row 2: a GT at IoU exactly 0.5 with a level-3 anchor
    anchor = anchors.boxes[0][2, 3, 0]              # (y1, x1, y2, x2), a 32 px square
    boxes[2, 0] = [anchor[0], anchor[1], anchor[2], anchor[1] + (anchor[3] - anchor[1]) / 2]
    boxes[2, 1] = [40, 40, 56, 60]
    classes[2, :2] = [2, 4]
    valid[2, :2] = True
    want = jax.vmap(lambda b, c, v: janchors.generate_targets(b, c, CLASSES, valid=v))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    got = anchors.generate_targets(torch.from_numpy(boxes), torch.from_numpy(classes), CLASSES,
                                   torch.from_numpy(valid))
    for level, (gb, gc, gm, wb, wc, wm) in enumerate(zip(*got, *want)):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm), err_msg=f"mask {level}")
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc), err_msg=f"classes {level}")
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-6)
        assert gc.dtype == torch.float32 and gm.dtype == torch.bool
    assert not any(m[1].any() for m in got[2])           # the padded row has no positive
    assert bool(got[2][0][2, 2, 3, 0, 0])                 # IoU 0.5 is positive
    assert sum(int(m[0].sum()) for m in got[2]) > 0


# --------------------------------------------------------------- whole loss
_JAX_FLOAT64 = {}


def jax_float64(d0_case):
    """JAX's float64 loss and gradients of the case, and its loss with
    ``reference_focal_reduction`` (computed once for both dtypes)."""
    if not _JAX_FLOAT64:
        cfg, variables, images, targets = d0_case
        with jax.enable_x64(True):
            flax_model = FlaxEfficientDetNet(config=cfg, dtype=jnp.float64)
            cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
            batch = {"image": jnp.asarray(images, jnp.float64),
                     "boxes": tuple(jnp.asarray(t, jnp.float64) for t in targets[0]),
                     "classes": tuple(jnp.asarray(t, jnp.float64) for t in targets[1]),
                     "masks": tuple(jnp.asarray(t) for t in targets[2])}

            def loss(reference):
                fn = jax_d0_loss_fn(flax_model, reference_focal_reduction=reference)
                return lambda p: fn(p, cast["batch_stats"], batch, jax.random.key(0))

            (value, _), grads = jax.jit(jax.value_and_grad(loss(False), has_aux=True))(
                cast["params"])
            reference, _ = jax.jit(loss(True))(cast["params"])
            _JAX_FLOAT64.update(loss=float(value), reference_loss=float(reference),
                                grads=jax.tree.map(np.asarray, grads))
    return _JAX_FLOAT64


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_whole_d0_loss_and_gradients_match_jax(d0_case, dtype):
    cfg, variables, images, targets = d0_case
    want = jax_float64(d0_case)
    tdtype = getattr(torch, dtype)
    net = EfficientDetNet(cfg, dtype=tdtype, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    net = net.to(tdtype).train()
    batch = {"image": torch.from_numpy(images).to(tdtype),
             "boxes": tuple(torch.from_numpy(t).to(tdtype) for t in targets[0]),
             "classes": tuple(torch.from_numpy(t).to(tdtype) for t in targets[1]),
             "masks": tuple(torch.from_numpy(t) for t in targets[2])}
    loss, _ = make_efficientdet_loss_fn()(net, batch)
    with torch.no_grad():
        reference, _ = make_efficientdet_loss_fn(reference_focal_reduction=True)(net, batch)
    assert loss.dtype == reference.dtype == tdtype
    if dtype == "float32":
        # the two packages' float32 losses sit farther apart than 1e-5 here
        # (train-mode BatchNorm over 2 values at the 1 x 1 levels); the port's
        # must be within 1e-5 of float64
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
        np.testing.assert_allclose(reference.item(), want["reference_loss"], rtol=1e-5)
        return
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-9)
    np.testing.assert_allclose(reference.item(), want["reference_loss"], rtol=1e-9)
    assert reference.item() < loss.item() / 2           # the mean underweights the focal term
    loss.backward()
    grads = flax_to_state_dict({"params": want["grads"],
                                "batch_stats": variables["batch_stats"]}, net)
    named = dict(net.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(want["grads"]))
    # leaves below 1e-12 of the largest gradient are zero to float64 (the box
    # net's levels without positives are exactly 0)
    floor = 1e-12 * max(float(grads[n].abs().max()) for n in named)
    for name, p in named.items():
        g, w = p.grad, grads[name].double()
        assert float((g - w).abs().max()) <= max(1e-6 * float(w.abs().max()), floor), name


# ------------------------------------------------------------- train steps
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


def jax_tiny_loss(params, batch_stats, batch, rng):
    out, mutated = FlaxTiny().apply({"params": params, "batch_stats": batch_stats},
                                    batch["image"], train=True, mutable=["batch_stats"])
    return jnp.mean(jnp.square(out - batch["target"])), (mutated["batch_stats"], {})


def tiny_loss(model, batch):
    return torch.mean(torch.square(model(batch["image"]) - batch["target"])), {}


@pytest.fixture()
def tiny(rng):
    shapes = jax.eval_shape(FlaxTiny().init, jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    batches = [{"image": rng.normal(0, 1, (4, 8, 8, 3)).astype(np.float32),
                "target": rng.normal(0, 1, (4, 8, 8, 4)).astype(np.float32)} for _ in range(3)]
    model = Tiny()
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return variables, batches, model


def assert_model_close(model, params, batch_stats):
    want = flax_to_state_dict(jax.tree.map(np.asarray, {"params": params,
                                                        "batch_stats": batch_stats}))
    state = model.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), **TOL, err_msg=key)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_sgd_cosine_clip_ema_step_matches_jax(tiny):
    variables, batches, model = tiny
    schedule_args = (0.5, 0.05, 2, 6)               # warmup 2 steps of 6
    tx = optax.sgd(jax_cosine(*schedule_args), momentum=0.9)
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                  ema_decay=0.9)
    jstep = jax.jit(jax_make_train_step(jax_tiny_loss, tx, clip_global_norm=0.5, ema_decay=0.9))
    optimizer = torch.optim.SGD(model.parameters(), lr=1.0, momentum=0.9)
    state = TrainState.create(model, optimizer, ema_decay=0.9)
    step = make_train_step(tiny_loss, clip_global_norm=0.5, ema_decay=0.9,
                           lr_schedule=cosine_lr_schedule(*schedule_args))
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax_batch(batch), jax.random.key(i))
        m = step(state, torch_batch(batch))
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL, err_msg=key)
        assert float(jm["gnorm"]) > 0.5                         # the clip bites
    assert state.ema_batch_stats is None and state.step == 3
    assert_model_close(model, jstate.params, jstate.batch_stats)
    ema = flax_to_state_dict(jax.tree.map(np.asarray, {"params": jstate.ema_params,
                                                       "batch_stats": jstate.batch_stats}))
    for key, value in state.ema_params.items():
        np.testing.assert_allclose(value.numpy(), ema[key].numpy(), **TOL, err_msg=key)


def test_sgd_state_bridge_continues_jax(tiny):
    variables, batches, model = tiny
    schedule_args = (0.3, 0.03, 1, 5)
    tx = optax.sgd(jax_cosine(*schedule_args), momentum=0.9)
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    jstep = jax.jit(jax_make_train_step(jax_tiny_loss, tx))
    for i in range(2):
        jstate, _ = jstep(jstate, jax_batch(batches[i]), jax.random.key(i))
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}), model), strict=True)
    optimizer = torch.optim.SGD(model.parameters(), lr=1.0, momentum=0.9)
    optimizer.load_state_dict(optax_sgd_state_dict(jstate.opt_state, model, optimizer))
    state = TrainState.create(model, optimizer)
    state.step = int(jstate.step)
    step = make_train_step(tiny_loss, lr_schedule=cosine_lr_schedule(*schedule_args))
    jstate, jm = jstep(jstate, jax_batch(batches[2]), jax.random.key(2))
    m = step(state, torch_batch(batches[2]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    assert_model_close(model, jstate.params, jstate.batch_stats)
    with pytest.raises(KeyError, match="TraceState"):
        optax_sgd_state_dict(optax.adam(1e-3).init(jstate.params), model, optimizer)


def test_line_search_step_matches_jax(tiny):
    variables, batches, model = tiny
    kw = dict(init_lr=20.0, shrink=0.3, clip_global_norm=10.0)     # 20 overshoots
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], optax.sgd(0.1))
    jstep = jax.jit(jax_line_search(jax_tiny_loss, **kw))
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=0.1))
    step = make_line_search_train_step(tiny_loss, **kw)
    for i, batch in enumerate(batches[:2]):
        jstate, jm = jstep(jstate, jax_batch(batch), jax.random.key(i))
        m = step(state, torch_batch(batch))
        for key in ("loss", "new_loss", "gnorm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL, err_msg=key)
        assert float(jm["new_loss"]) < float(jm["loss"])
        # the statistics are the first forward's: one update per step, not one per try
        assert_model_close(model, jstate.params, jstate.batch_stats)
    assert state.step == 2 and int(model.ConvBN_0.BatchNorm_0.num_batches_tracked) == 2
    assert all(p.grad is None for p in model.parameters())


def test_line_search_rewinds_the_dropout_generator(d0_case):
    """Every try draws the first forward's drop_connect masks: the kept
    candidate's loss, evaluated again with the rewound generator, is the step's
    ``new_loss``; the generator ends where the first forward left it."""
    cfg, variables, images, targets = d0_case
    cfg = d0_config(survival_prob=0.5)
    net = EfficientDetNet(cfg, device="cpu")
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    gen = torch.Generator().manual_seed(7)
    loss_fn = make_efficientdet_loss_fn(generator=gen)
    batch = {"image": torch.from_numpy(images),
             "boxes": tuple(torch.from_numpy(t) for t in targets[0]),
             "classes": tuple(torch.from_numpy(t) for t in targets[1]),
             "masks": tuple(torch.from_numpy(t) for t in targets[2])}
    state = TrainState.create(net, torch.optim.SGD(net.parameters(), lr=0.1))
    start = gen.get_state()
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    m = make_line_search_train_step(loss_fn, init_lr=1.0, generator=gen)(state, batch)
    after = gen.get_state()
    moved = {k: v for k, v in net.state_dict().items() if "running" in k}
    assert any(not torch.equal(stats[k], moved[k]) for k in stats)
    gen.set_state(start)
    with torch.no_grad():
        again, _ = loss_fn(net.train(), batch)
    assert torch.equal(gen.get_state(), after)
    np.testing.assert_allclose(float(again), float(m["new_loss"]), rtol=1e-6)


# ------------------------------------------------------------ drop_connect
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_connect_with_jax_draws(rng, dtype):
    x = rng.normal(0, 1, (16, 4, 4, 8)).astype(np.float32)
    key = jax.random.key(3)
    jdtype = jnp.dtype(dtype)
    want = jax_drop_connect(jnp.asarray(x, jdtype), key, True, 0.8)
    uniform = jax.random.uniform(key, (16, 1, 1, 1), dtype=jdtype)
    tdtype = getattr(torch, dtype)
    got = drop_connect(torch.from_numpy(x).to(tdtype), 0.8,
                       torch.from_numpy(np.asarray(uniform.astype(jnp.float32))).to(tdtype))
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    kept = np.asarray(jnp.floor(0.8 + uniform.astype(jnp.float32)))
    assert 0 < kept.sum() < 16


# --------------------------------------------------------------- GIoU/CIoU
def yxyx_pairs(rng, n=64):
    """Target/prediction pairs: random, coincident, zero-area and disjoint."""
    c = rng.uniform(10, 90, (n, 2, 2))
    hw = rng.uniform(2, 30, (n, 2, 2))
    boxes = np.concatenate([c - hw / 2, c + hw / 2], -1).astype(np.float32)
    boxes[0, 1] = boxes[0, 0]
    boxes[1, 0, 2] = boxes[1, 0, 0]
    boxes[2, 1] = boxes[2, 0] + 200.0
    return boxes[:, 0], boxes[:, 1]


@pytest.mark.parametrize("iou_type", ["giou", "ciou"])
def test_yxyx_giou_ciou_and_gradients_match_jax(rng, iou_type):
    target, pred = yxyx_pairs(rng)

    def jax_sum(t, p):
        return jnp.sum(jax_iou_yxyx(t, p, iou_type))

    want = jax_iou_yxyx(jnp.asarray(target), jnp.asarray(pred), iou_type)
    want_gt, want_gp = jax.grad(jax_sum, argnums=(0, 1))(jnp.asarray(target), jnp.asarray(pred))
    t = torch.tensor(target, requires_grad=True)
    p = torch.tensor(pred, requires_grad=True)
    got = iou_yxyx(t, p, iou_type)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_gt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_gp), rtol=1e-5, atol=1e-5)
