"""``tmv_tpu_torch.cli.train_unet`` on the CPU at 32 px (depth 2, width 4).

- Its first step equals the JAX package's ``make_train_step`` step on the same
  weights and the same first batch (``optax.adam`` 1e-3, global-norm clip 10):
  the loss and every BatchNorm statistic of the saved step-1 checkpoint within
  rtol 1e-5, atol 1e-6, every parameter within rtol 1e-5 and 1% of lr (Adam's
  first update lr·g/(|g| + 1e-8) turns the float32 rounding of a gradient near
  1e-8 into a fraction of lr; float32 on both sides). The 3×3
  convs' biases feed train-mode BatchNorms, so their gradient is 0 up to
  rounding and Adam moves each by ±lr whichever way the rounding points: on
  both sides they are checked to have moved by at most lr.
- Four steps with ``--dumpEvery 2``: checkpoints at steps 2 and 4, the input,
  target and prediction dumps of both windows; then a resume to step 6 that
  continues from step 4; a bad learning rate stops early; ``--remat`` trains;
  the CLI wants a card by default.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_train_step as jax_make_train_step
from tmv_tpu.data.unet_dataset import get_dataset as jax_get_dataset
from tmv_tpu.models import unet as jax_unet
from tmv_tpu_torch.cli import train_unet
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models import unet
from torch_port_cases import seeded_variables, write_labelme

SMALL = ["--inputSize", "32", "--depth", "2", "--filtersBase", "4", "--batchSize", "2",
         "--device", "cpu"]


@pytest.fixture()
def labelme(tmp_path):
    write_labelme(tmp_path)
    return tmp_path


def test_first_step_equals_jax(labelme, tmp_path, monkeypatch):
    model = jax_unet.UNetLogits(depth=2, filters_base=4, output_filters=4)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(0)))

    def bridged_init(net, seed):
        net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
        return net

    monkeypatch.setattr(unet, "init_weights", bridged_init)
    ckpt = tmp_path / "ckpt"
    out = train_unet.main(["--labelPath", str(labelme), "--steps", "1", "--modelPath",
                           str(ckpt)] + SMALL)
    assert out["step"] == 1 and len(out["losses"]) == 1

    batches, _ = jax_get_dataset(str(labelme), 2, 4, (32, 32), (32, 32))
    batch = next(batches)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    step = jax.jit(jax_make_train_step(jax_unet.make_unet_loss_fn(model), tx,
                                       clip_global_norm=10.0))
    state, metrics = step(state, batch, jax.random.key(0))
    np.testing.assert_allclose(out["losses"][0], float(metrics["loss"]), rtol=1e-5)
    want = flax_to_state_dict(jax.tree.map(np.asarray, {"params": state.params,
                                                        "batch_stats": state.batch_stats}))
    got = torch.load(ckpt / "1.pt", weights_only=True)["model"]
    before = flax_to_state_dict(variables)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("Conv_0.bias") and not key.startswith("Conv_0"):
            # a 3x3 conv's bias feeds a train-mode BatchNorm: its gradient is 0 up
            # to rounding, so Adam's first step moves it by ±lr either way
            for side in (got[key], value):
                assert float((side - before[key]).abs().max()) <= 1e-3 * (1 + 1e-5), key
            continue
        # Adam's first update is lr·g/(|g| + 1e-8): where |g| comes near 1e-8 the
        # float32 rounding of g moves it by a fraction of lr, so updates are held
        # within 1% of lr, the statistics within rtol 1e-5, atol 1e-6
        atol = 1e-5 if key in before and not key.endswith(("running_mean", "running_var")) \
            else 1e-6
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-5, atol=atol,
                                   err_msg=key)


def test_dumps_resume_and_early_stopping(labelme, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    base = ["--labelPath", str(labelme), "--modelPath", str(ckpt), "--dumpEvery", "2"] + SMALL
    out = train_unet.main(base + ["--steps", "4"])
    assert out["step"] == 4 and all(np.isfinite(out["losses"]))
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) == ["2.pt", "4.pt"]
    dumps = sorted(os.listdir(ckpt / "dumps"))
    assert dumps == sorted([f"in_{i}.jpg" for i in (1, 3)]
                           + [f"{kind}_{i}_{c}.jpg" for kind in ("pred", "target")
                              for i in (1, 3) for c in range(4)])
    assert "5 labels" in capsys.readouterr().out
    again = train_unet.main(base + ["--steps", "6"])
    assert again["step"] == 6 and len(again["losses"]) == 2
    assert "resumed from step 4" in capsys.readouterr().out

    wild = train_unet.main(["--labelPath", str(labelme), "--modelPath", str(tmp_path / "w"),
                            "--dumpEvery", "1", "--earlyStopPatience", "1", "--lr", "100",
                            "--steps", "10"] + SMALL)
    assert wild["step"] < 10 and "early stopping" in capsys.readouterr().out

    remat = train_unet.main(["--labelPath", str(labelme), "--modelPath", str(tmp_path / "r"),
                             "--steps", "2", "--remat"] + SMALL)
    assert remat["step"] == 2 and all(np.isfinite(remat["losses"]))
    args = train_unet.parse_args(["--labelPath", "x"])
    assert (args.device, args.inputSize, args.depth, args.filtersBase, args.pointsNum,
            args.batchSize, args.lr) == ("cuda", 128, 4, 16, 4, 4, 1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_unet.main(["--labelPath", str(labelme)])
