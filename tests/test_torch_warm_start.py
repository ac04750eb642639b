"""YOLOv3 training in the port against the JAX package: the loss, the layer
freezing and the two-phase Darknet warm start, on the CPU.

- The whole ``YoloV3(classes_num=3)`` at 64 × 64, B = 2, on bridged seeded
  weights in train mode: the loss of ``make_yolo_loss_fn(iou_type="iou")`` (v3's)
  and every parameter's gradient in float64 on both sides (JAX under
  ``jax.enable_x64``; float32 rounding through batch statistics over 8 values
  per channel would hide the arithmetic, see ``test_torch_losses.py``): loss
  rtol 1e-9, each gradient within 1e-6·max|grad| of its leaf, as YOLOv4's.
- ``freeze_mask(model, ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2"))``
  equals the JAX package's mask leaf by leaf (through the bridge's key map).
- Three warm-up steps, float64 on both sides: ``masked_optimizer`` (Adam over
  the trainable parameters only) with the shadow loss against JAX's
  ``masked_optimizer(optax.adam)``: the losses and the trained parameters
  within the step tests' rtol 1e-5 / atol 1e-6, every frozen parameter
  bit-equal to where it started, no optimizer state for a frozen one, and the
  BatchNorm statistics within 1e-7 of their largest entry.
- ``cli/train_yolo.py --version v3 --darknetWeights … --warmupSteps 2 --device
  cpu`` end to end at 64 px: after the warm-up (``--epochs 0`` saves it) every
  parameter outside the three output convs is bit-equal to the stream and the
  output convs and BatchNorm statistics moved; a run with epochs trains,
  validates and checkpoints from step 0 with a fresh Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_train_step as jax_make_train_step
from tmv_tpu.models import detector_harness as jax_harness
from tmv_tpu.models.yolo_v3 import YoloV3 as FlaxYoloV3
from tmv_tpu_torch.cli import train_yolo
from tmv_tpu_torch.convert.darknet import save_darknet_weights
from tmv_tpu_torch.convert.flax_bridge import _map_leaf, flax_to_state_dict
from tmv_tpu_torch.core.train_state import TrainState, make_train_step
from tmv_tpu_torch.models.detector_harness import (
    freeze_mask, frozen, make_yolo_loss_fn, masked_optimizer,
)
from tmv_tpu_torch.models.layers.common import init_weights
from tmv_tpu_torch.models.yolo_v3 import YoloV3
from torch_port_cases import (  # noqa: F401
    disposable_tmp, seeded_variables, write_tiny_set, yolo_targets_batch,
)

ANCHORS = np.array([[[32, 28], [40, 44], [60, 50]],
                    [[14, 18], [20, 16], [24, 30]],
                    [[4, 6], [8, 7], [10, 12]]], np.float32)
HEADS = ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2")


@pytest.fixture(scope="module")
def v3_case():
    """Seeded float32 weights of ``YoloV3(classes_num=3)`` and three 64 × 64
    batches of 2."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(FlaxYoloV3(classes_num=3).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    return variables, [yolo_targets_batch(rng, ANCHORS) for _ in range(3)]


def port_net(variables):
    net = YoloV3(3, dtype=torch.float64)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    return net.to(torch.float64).train()


def port_batch(images, targets):
    return {"image": torch.from_numpy(images).double(),
            "targets": tuple(torch.from_numpy(t).double() for t in targets)}


def jax_batch(images, targets):
    return {"image": jnp.asarray(images, jnp.float64),
            "targets": tuple(jnp.asarray(t, jnp.float64) for t in targets)}


def test_whole_yolov3_loss_and_gradients_match_jax_in_float64(v3_case):
    variables, batches = v3_case
    images, targets = batches[0]
    with jax.enable_x64(True):
        model = FlaxYoloV3(classes_num=3, dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        loss_fn = jax_harness.make_yolo_loss_fn(model, (64, 64), ANCHORS, iou_type="iou")
        (want, (new_stats, _)), want_grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, cast["batch_stats"], jax_batch(images, targets), None),
            has_aux=True))(cast["params"])
        grads = flax_to_state_dict(jax.tree.map(np.asarray, {"params": want_grads,
                                                             "batch_stats": new_stats}))
        want = float(want)
    net = port_net(variables)
    loss, _ = make_yolo_loss_fn((64, 64), ANCHORS, iou_type="iou")(net, port_batch(images, targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=1e-9)
    named = dict(net.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(want_grads))
    for name, p in named.items():
        w = grads[name].double()
        assert float((p.grad - w).abs().max()) <= 1e-6 * float(w.abs().max()), name


def test_freeze_mask_matches_jax(v3_case):
    variables, _ = v3_case
    want = jax_harness.freeze_mask(variables["params"], list(HEADS))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    mapped = {_map_leaf("params", tuple(p.key for p in path))[0]: bool(leaf)
              for path, leaf in flat}
    got = freeze_mask(YoloV3(3), HEADS)
    assert got == mapped
    assert sum(got.values()) == 6 and len(got) == 222


def test_masked_warm_up_matches_jax(v3_case):
    variables, batches = v3_case
    lr = 1e-3
    with jax.enable_x64(True):
        model = FlaxYoloV3(classes_num=3, dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        mask = jax_harness.freeze_mask(cast["params"], list(HEADS))
        tx = jax_harness.masked_optimizer(optax.adam(lr), mask)
        jstate = JaxTrainState.create(cast["params"], cast["batch_stats"], tx)
        loss_fn = jax_harness.make_yolo_loss_fn(model, (64, 64), ANCHORS, iou_type="iou")
        jstep = jax.jit(jax_make_train_step(loss_fn, tx, shadow_loss=True))
        jax_losses = []
        for i, (images, targets) in enumerate(batches):
            jstate, metrics = jstep(jstate, jax_batch(images, targets), jax.random.key(i))
            jax_losses.append((float(metrics["loss"]), float(metrics["raw_loss"])))
        want = flax_to_state_dict(jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))

    net = port_net(variables)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    mask = freeze_mask(net, HEADS)
    optimizer = masked_optimizer(
        lambda params: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
        net, mask)
    assert all(p.requires_grad for p in net.parameters())
    state = TrainState.create(net, optimizer)
    step = make_train_step(make_yolo_loss_fn((64, 64), ANCHORS, iou_type="iou"),
                           shadow_loss=True)
    with frozen(net, mask):
        losses = [step(state, port_batch(*b)) for b in batches]
    assert all(p.requires_grad for p in net.parameters())
    for m, (loss, raw) in zip(losses, jax_losses):
        np.testing.assert_allclose([float(m["loss"]), float(m["raw_loss"])], [loss, raw],
                                   rtol=1e-5, atol=1e-6)
    trained = {id(p) for group in optimizer.param_groups for p in group["params"]}
    assert len(trained) == 6 and len(optimizer.state) == 6
    got = net.state_dict()
    for name, p in net.named_parameters():
        if mask[name]:
            assert id(p) in trained
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            assert not torch.equal(got[name], start[name]), name
        else:
            assert torch.equal(got[name], start[name]), name
            np.testing.assert_array_equal(want[name].numpy(), start[name].float().numpy())
    for name in got:
        if name.endswith(("running_mean", "running_var")):
            w = want[name].double()
            assert float((got[name] - w).abs().max()) <= 1e-7 * float(w.abs().max()), name
            assert not torch.equal(got[name], start[name]), name


def test_train_cli_darknet_warm_start_on_cpu(disposable_tmp, capsys):
    tmp_path = disposable_tmp
    files = write_tiny_set(tmp_path)
    source = YoloV3(3)
    init_weights(source, 3)
    stream = str(tmp_path / "v3.weights")
    save_darknet_weights(source, stream, input_size=64)
    base = ["--version", "v3", "--trainData", files["labels"], "--trainImagePath",
            files["images"], "--classesFile", files["classes"], "--anchorsFile",
            files["anchors"], "--imageSize", "64", "--batchSize", "2", "--stepsPerEpoch", "2",
            "--lr", "1e-3", "--darknetWeights", stream, "--warmupSteps", "2", "--device", "cpu"]

    warmed = tmp_path / "warmed"
    assert train_yolo.main(base + ["--epochs", "0", "--modelPath", str(warmed)])["step"] == 0
    out = capsys.readouterr().out
    assert "loaded darknet weights" in out and "warm start done" in out
    saved = torch.load(warmed / "0.pt", weights_only=True)
    want = source.state_dict()
    for name, _ in source.named_parameters():
        moved = not torch.equal(saved["model"][name], want[name])
        assert moved == name.startswith(HEADS), name
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert all(not torch.equal(saved["model"][k], want[k]) for k in stats)
    assert saved["optimizer"]["state"] == {}        # the main Adam is fresh

    trained = tmp_path / "trained"
    result = train_yolo.main(base + ["--epochs", "1", "--modelPath", str(trained),
                                     "--valData", files["labels"], "--valImagePath",
                                     files["images"]])
    assert result["step"] == 2 and len(result["val_mAP"]) == 1
    saved = torch.load(trained / "2.pt", weights_only=True)
    assert {int(v["step"]) for v in saved["optimizer"]["state"].values()} == {2}
    assert len(saved["optimizer"]["state"]) == len(want) - 3 * len(stats) // 2
