"""The port's UNet family against the JAX package's, on the CPU.

- ``UNet`` and ``UNetLogits`` (depth 2, width 4, 4 output channels) bridged from
  seeded flax variables, on 32 px and on 50 px (its 25 px skip shrinks to 24 px:
  the antialiased resize), in eval mode in float32: within 1e-5·max|ref|; in
  train mode in float64: outputs within 1e-10·max|ref| and every BatchNorm
  statistic after the forward within 1e-10 of its largest entry.
- ``make_unet_loss_fn`` in float64: the loss within 1e-10 of JAX's
  ``make_unet_loss_fn`` and every gradient within 1e-10 of the largest gradient
  entry (the convs' biases before a train-mode BatchNorm have gradient 0).
- ``SoftLabel`` with points in range, on the border and out of range (zero
  channels), and ``gaussian_kernel_2d``: within 1e-6. ``focus_loss`` within 1e-6.
- The ``image_helper`` copies (``perspective`` with its points, ``random_noise``,
  ``random_color_jitter``, ``random_lines``, ``crop``) equal JAX's on one seed.
- ``order_corners``, ``load_labelme_labels`` and ``get_dataset`` at one seed
  against JAX's over three batches of synthetic labelme files of a 4-corner
  quad: images bit-equal, targets within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.data import unet_dataset as jax_dataset
from tmv_tpu.models import unet as jax_unet
from tmv_tpu.ops import losses as jax_losses
from tmv_tpu.ops import soft_label as jax_soft_label
from tmv_tpu.utils import image_helper as jax_image_helper
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.data import unet_dataset
from tmv_tpu_torch.models.unet import UNet, UNetLogits, init_weights, make_unet_loss_fn
from tmv_tpu_torch.ops import losses, soft_label
from tmv_tpu_torch.utils import image_helper
from torch_port_cases import by_torch_name, seeded_variables, write_labelme

KW = dict(depth=2, filters_base=4, output_filters=4)


def flax_variables(size, seed=0):
    shapes = jax.eval_shape(jax_unet.UNetLogits(**KW).init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)))
    return jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(seed)))


def bridged(cls, variables, dtype=torch.float32):
    net = cls(**KW)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    return net.to(dtype)


@pytest.mark.parametrize("size", [32, 50])
def test_unet_matches_flax_in_eval_mode(size):
    variables = flax_variables(size)
    images = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    for jax_cls, cls in ((jax_unet.UNet, UNet), (jax_unet.UNetLogits, UNetLogits)):
        want = np.asarray(jax_cls(**KW).apply(variables, jnp.asarray(images)))
        with torch.no_grad():
            got = bridged(cls, variables).eval()(torch.from_numpy(images)).numpy()
        out = size // 4 * 4                 # the last decoder stage's input size
        assert got.shape == want.shape == (2, out, out, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("size", [32, 50])
def test_unet_train_mode_and_statistics_match_flax_in_float64(size):
    variables = flax_variables(size, seed=1)
    images = np.random.default_rng(7).uniform(0, 1, (2, size, size, 3))
    with jax.enable_x64(True):
        model = jax_unet.UNetLogits(**KW, dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, mutated = model.apply(cast, jnp.asarray(images), train=True,
                                    mutable=["batch_stats"])
        want = np.asarray(want)
        stats = by_torch_name(mutated["batch_stats"])
    net = bridged(UNetLogits, variables, torch.float64).train()
    with torch.no_grad():
        got = net(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    state = net.state_dict()
    assert len(stats) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    for key, w in stats.items():
        assert np.abs(state[key].numpy() - w).max() <= 1e-10 * np.abs(w).max(), key


def test_unet_loss_and_gradients_match_jax_in_float64():
    variables = flax_variables(32, seed=2)
    rng = np.random.default_rng(3)
    batch = {"image": rng.uniform(0, 1, (2, 32, 32, 3)),
             "target": rng.uniform(0, 1, (2, 32, 32, 4)) * (rng.uniform(size=(2, 32, 32, 4)) < .3)}
    with jax.enable_x64(True):
        model = jax_unet.UNetLogits(**KW, dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        loss_fn = jax_unet.make_unet_loss_fn(model)
        (want, _), grads = jax.value_and_grad(
            lambda p: loss_fn(p, cast["batch_stats"], jax.tree.map(jnp.asarray, batch), None),
            has_aux=True)(cast["params"])
        want_grads = by_torch_name(grads)
    net = bridged(UNetLogits, variables, torch.float64).train()
    loss, aux = make_unet_loss_fn()(net, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert aux == {}
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-10)
    got = dict(net.named_parameters())
    assert set(got) == set(want_grads)
    # the convs' biases before a train-mode BatchNorm have gradient 0 up to rounding
    scale = max(np.abs(w).max() for w in want_grads.values())
    for key, w in want_grads.items():
        if got[key].grad is None:           # the last stage's unused upsample BatchNorm
            assert key.startswith("UpSample_2.BatchNorm_0") and not w.any(), key
            continue
        np.testing.assert_allclose(got[key].grad.numpy(), w, rtol=0, atol=1e-10 * scale,
                                   err_msg=key)


def test_bridge_keys_init_and_remat_keys():
    variables = flax_variables(32)
    net = UNet(**KW)
    assert set(flax_to_state_dict(variables, net)) == set(net.state_dict())
    assert set(UNet(**KW, remat=True).state_dict()) == set(net.state_dict())
    init_weights(net, 0)
    a = dict(net.state_dict())
    init_weights(net, 0)
    assert all(torch.equal(a[k], v) for k, v in net.state_dict().items())
    w = net.DownSample_0.UNetConv_0.Conv_0.weight
    assert abs(float(w.detach().std()) - np.sqrt(2 / 27)) < 0.3 * np.sqrt(2 / 27)


def test_soft_label_and_kernel_match_jax():
    np.testing.assert_allclose(soft_label.gaussian_kernel_2d((11, 11, 2, 3), 1.5),
                               jax_soft_label.gaussian_kernel_2d((11, 11, 2, 3), 1.5),
                               rtol=0, atol=1e-6)
    points = np.array([[3, 4], [0, 31], [31, 0], [-1, 5], [10, 40], [16, 16]], np.int32)
    ours = soft_label.SoftLabel((32, 40), 6, (11, 11))
    theirs = jax_soft_label.SoftLabel((32, 40), 6, (11, 11))
    got = ours.get_target(torch.from_numpy(points)).numpy()
    want = np.asarray(theirs.get_target(jnp.asarray(points)))
    assert got.shape == (32, 40, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[..., 3].max() == 0 and got[..., 4].max() == 0      # out of range: zero
    assert got[3, 4, 0] == pytest.approx(1.0)


def test_focus_loss_matches_jax(rng):
    y_true = rng.uniform(0, 1, (2, 16, 16, 4)) * (rng.uniform(size=(2, 16, 16, 4)) < 0.2)
    logits = rng.normal(0, 2, (2, 16, 16, 4))
    for dtype in (np.float32, np.float64):
        got = losses.focus_loss(torch.from_numpy(y_true.astype(dtype)),
                                torch.from_numpy(logits.astype(dtype)))
        with jax.enable_x64(dtype == np.float64):
            want = jax_losses.focus_loss(jnp.asarray(y_true.astype(dtype)),
                                         jnp.asarray(logits.astype(dtype)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_image_helper_copies_match_jax():
    img = np.random.default_rng(4).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    points = np.array([[5.0, 6.0], [50.0, 4.0], [8.0, 35.0], [47.0, 33.0]])
    for ours, theirs in ((image_helper, jax_image_helper),):
        got, got_pts = ours.perspective(img, points=points, degrees=(12.0, -7.0, 5.0))
        want, want_pts = theirs.perspective(img, points=points, degrees=(12.0, -7.0, 5.0))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_pts, want_pts)
        for name in ("random_noise", "random_color_jitter", "random_lines"):
            np.testing.assert_array_equal(
                getattr(ours, name)(img, np.random.default_rng(9)),
                getattr(theirs, name)(img, np.random.default_rng(9)), err_msg=name)
        np.testing.assert_array_equal(ours.crop(img, 3, 4, 20, 30),
                                      theirs.crop(img, 3, 4, 20, 30))


def test_dataset_matches_jax_at_one_seed(tmp_path):
    write_labelme(tmp_path)
    pts = np.float32([[60, 10], [10, 12], [12, 50], [58, 52]])
    np.testing.assert_array_equal(unet_dataset.order_corners(pts),
                                  jax_dataset.order_corners(pts))
    assert unet_dataset.order_corners(np.float32([[0, 0], [1, 0], [2, 0], [3, 0]])) is None
    for first in (False, True):
        got = unet_dataset.load_labelme_labels(str(tmp_path), first)
        want = jax_dataset.load_labelme_labels(str(tmp_path), first)
        assert len(got) == len(want) == 5 + first
        for g, w in zip(got, want):
            assert g["image_path"] == w["image_path"]
            np.testing.assert_array_equal(g["points"], w["points"])
    ours, gen = unet_dataset.get_dataset(str(tmp_path), 2, 4, (32, 32), (32, 32), seed=3)
    theirs, _ = jax_dataset.get_dataset(str(tmp_path), 2, 4, (32, 32), (32, 32), seed=3)
    assert gen.labels_num == 5
    for _ in range(3):
        got, want = next(ours), next(theirs)
        assert got["image"].dtype == torch.float32 and got["image"].shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))
        assert got["target"].shape == (2, 32, 32, 4)
        np.testing.assert_allclose(got["target"].numpy(), np.asarray(want["target"]),
                                   rtol=0, atol=1e-6)
        assert float(got["target"].max()) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="no usable labelme"):
        unet_dataset.get_dataset(str(tmp_path / "none"), 2, 4, (32, 32), (32, 32))
