"""The port's FaceNet training against the JAX package's, on the CPU.

- ``train_facenet.make_optimizer``: ADAGRAD, ADADELTA, ADAM and RMSPROP over 3
  steps on the same float64 gradients equal optax's (``optax.adagrad``,
  ``adadelta``, ``adam``, ``rmsprop(decay=0.9, momentum=0.9, eps=1.0)``) within
  1e-12 of the largest parameter; torch's own ``RMSprop`` and ``Adagrad`` (eps
  outside the square root, the accumulator from 0) do not.
- The triplet train step (``make_triplet_train_step`` through
  ``make_train_step(shadow_loss=True, ema_decay=0.99)``) on IRv1 at 112 px with
  2 triplets per step, float64, dropout rate 0, three steps against JAX's
  ``make_train_step``: the reported and raw losses within 1e-7; each step's
  parameter update within 1e-7 of the largest update entry (plain SGD, so the
  update is lr times the shadow-scaled gradient; Adam's rule is held above and
  divides gradients near its eps, such as the exact-zero gradients of the convs'
  biases before a train-mode BatchNorm, by nearly themselves); the BatchNorm
  statistics and the EMA parameters within 1e-7 of each tensor's largest entry.
  The tolerance is the problem's conditioning, not the port's: train-mode
  BatchNorm over 6 images at 2 × 2 under 20 unscaled residual blocks amplifies
  rounding, and the test measures it: JAX's own run from initial weights
  nudged by 1e-15 (relative, rounding level) ends its third step more than
  1e-11 away from the un-nudged run.
- ``cli/train_facenet.py --device cpu`` at 80 px for one outer step on 4 synthetic
  people (with the LFW flags): its checkpoint loads in ``validate_on_lfw`` and
  ``facenet_distance``; a second run resumes the step count. On seeded weights
  carried from a JAX checkpoint by ``flax_to_state_dict``, the port's
  ``validate_on_lfw`` prints the JAX CLI's four lines and its
  ``facenet_distance`` the JAX CLI's matrix.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmv_tpu.cli import facenet_distance as jax_distance_cli
from tmv_tpu.cli import validate_on_lfw as jax_validate_cli
from tmv_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_train_step as jax_make_train_step
from tmv_tpu.models.facenet import FaceNetModel as JaxFaceNet
from tmv_tpu.models.facenet import make_triplet_train_step as jax_triplet_step
from tmv_tpu_torch.cli import facenet_distance, train_facenet, validate_on_lfw
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.core.train_state import TrainState, make_train_step
from tmv_tpu_torch.models.facenet import FaceNetModel, make_triplet_train_step
from torch_port_cases import by_torch_name, seeded_variables, write_face_set, write_pairs
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

# the port's torch work on one thread: no OpenMP oversubscription under test workers
pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTAX = {"ADAGRAD": lambda lr: optax.adagrad(lr), "ADADELTA": lambda lr: optax.adadelta(lr),
         "ADAM": lambda lr: optax.adam(lr),
         "RMSPROP": lambda lr: optax.rmsprop(lr, decay=0.9, momentum=0.9, eps=1.0)}


def run_torch(optimizer_of, params0, grads):
    params = [torch.tensor(p, requires_grad=True) for p in params0]
    opt = optimizer_of(params)
    out = []
    for step in grads:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        opt.step()
        out.append([p.detach().numpy().copy() for p in params])
    return out


@pytest.mark.parametrize("name", list(OPTAX))
def test_optimizers_follow_optax(name):
    rng = np.random.default_rng(1)
    params0 = [rng.normal(size=(3, 4)), rng.normal(size=(5,))]
    grads = [[rng.normal(size=p.shape) * 0.3 for p in params0] for _ in range(3)]
    with jax.enable_x64(True):
        tx = OPTAX[name](0.05)
        params = [jnp.asarray(p) for p in params0]
        opt_state = tx.init(params)
        want = []
        for step in grads:
            updates, opt_state = tx.update([jnp.asarray(g) for g in step], opt_state, params)
            params = optax.apply_updates(params, updates)
            want.append([np.asarray(p) for p in params])
    got = run_torch(lambda ps: train_facenet.make_optimizer(name, 0.05, ps), params0, grads)
    for g_step, w_step in zip(got, want):
        for g, w in zip(g_step, w_step):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max())
    stock = {"RMSPROP": lambda ps: torch.optim.RMSprop(ps, lr=0.05, alpha=0.9, eps=1.0,
                                                       momentum=0.9),
             "ADAGRAD": lambda ps: torch.optim.Adagrad(ps, lr=0.05, eps=1e-7)}.get(name)
    if stock is not None:          # the trap the port's optimizers avoid
        off = run_torch(stock, params0, grads)[-1]
        assert max(np.abs(g - w).max() for g, w in zip(off, want[-1])) > 1e-3


def test_triplet_train_step_matches_jax_in_float64():
    tol = 1e-7
    flax_model = JaxFaceNet(16, dropout_rate=0.0)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 112, 112, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(2)))
    rng = np.random.default_rng(3)
    batches = [{k: rng.uniform(0, 1, (2, 112, 112, 3)) for k in ("anchor", "positive", "negative")}
               for _ in range(3)]
    with jax.enable_x64(True):
        model64 = flax_model.clone(dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = optax.sgd(0.01)
        state = JaxTrainState.create(cast["params"], cast["batch_stats"], tx, ema_decay=0.99)
        step = jax.jit(jax_make_train_step(jax_triplet_step(model64, tx, 0.2), tx,
                                           shadow_loss=True, ema_decay=0.99))
        want = [by_torch_name(state.params)]
        for batch in batches:
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
            want.append((float(metrics["loss"]), float(metrics["raw_loss"]),
                         by_torch_name(state.params), by_torch_name(state.batch_stats),
                         by_torch_name(state.ema_params)))
        noise = np.random.default_rng(5)
        nudged = jax.tree.map(lambda a: a * (1 + 1e-15 * noise.normal(size=a.shape)), cast)
        state = JaxTrainState.create(nudged["params"], nudged["batch_stats"], tx,
                                     ema_decay=0.99)
        for batch in batches:
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        assert abs(float(metrics["raw_loss"]) - want[-1][1]) > 1e-11   # the conditioning

    model = FaceNetModel(16, dropout_rate=0.0, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    model = model.double()
    port = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=0.01), ema_decay=0.99)
    step_fn = make_train_step(make_triplet_train_step(0.2, torch.Generator().manual_seed(0)),
                              shadow_loss=True, ema_decay=0.99)
    before, jax_before = dict(model.state_dict()), want[0]
    before = {k: v.numpy().copy() for k, v in before.items()}
    for batch, (loss, raw, params, stats, ema) in zip(batches, want[1:]):
        metrics = step_fn(port, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(metrics["loss"]) - loss) <= tol * max(1.0, abs(loss))
        assert abs(float(metrics["raw_loss"]) - raw) <= tol * max(1.0, abs(raw))
        got = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        updates = {k: params[k] - jax_before[k] for k in params}
        scale = max(np.abs(u).max() for u in updates.values())
        assert scale > 0
        for key, u in updates.items():
            assert np.abs((got[key] - before[key]) - u).max() <= tol * scale, key
        for key, w in stats.items():
            assert np.abs(got[key] - w).max() <= tol * np.abs(w).max(), key
        for key, w in ema.items():
            assert np.abs(port.ema_params[key].numpy() - w).max() <= tol * np.abs(w).max(), key
        before, jax_before = got, params
    assert port.step == 3 and port.ema_batch_stats is None


@pytest.fixture()
def face_tree(tmp_path):
    names = write_face_set(tmp_path / "train", people=4, images=3, size=96)
    lfw_names = write_face_set(tmp_path / "lfw", people=4, images=3, size=96, seed=1)
    write_pairs(tmp_path / "pairs.txt", lfw_names, 3, count=20)
    return tmp_path, names


def test_train_cli_on_cpu_then_validate_and_distance(face_tree, capsys):
    root, _ = face_tree
    ckpt = root / "ckpt"
    lfw_flags = ["--lfwDir", str(root / "lfw"), "--lfwPairs", str(root / "pairs.txt")]
    base = ["--filesPath", str(root / "train"), "--imageSize", "80", "--batchSize", "6",
            "--peoplePerBatch", "4", "--imagesPerPerson", "3", "--stepsPerEpoch", "1",
            "--embeddingSize", "16", "--modelPath", str(ckpt), "--device", "cpu"]
    out = train_facenet.main(base + ["--epochs", "1"] + lfw_flags)
    assert out["step"] >= 1 and len(out["losses"]) == out["step"]
    assert all(np.isfinite(out["losses"]))
    (outer,) = out["outer"]
    assert outer["train_steps"] == out["step"] == outer["triplets"] // 2
    assert len(out["lfw"]) == 1 and 0 <= out["lfw"][0][0].mean() <= 1
    assert os.listdir(ckpt) == [f"{out['step']}.pt"]
    printed = capsys.readouterr().out
    assert "epoch 0 outer" in printed and "LFW accuracy" in printed

    again = train_facenet.main(base + ["--epochs", "1", "--optimizer", "ADAM", "--remat"])
    assert again["step"] > out["step"] and "resumed from step" in capsys.readouterr().out

    common = ["--imageSize", "80", "--embeddingSize", "16", "--modelPath", str(ckpt),
              "--device", "cpu"]
    result = validate_on_lfw.main(lfw_flags + common)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines[-4:]] == [
        "Accuracy", "Validation rate", "Area Under Curve (AUC)", "Equal Error Rate (EER)"]
    assert 0 <= result["auc"] <= 1 and 0 <= result["eer"] <= 1
    images = sorted(str(p) for p in (root / "lfw").glob("*/*.jpg"))[:4]
    matrix = facenet_distance.main(images + common)
    assert matrix.shape == (4, 4) and np.allclose(matrix, matrix.T)
    assert np.all(np.diag(matrix) == 0)


def test_validate_and_distance_equal_the_jax_clis(face_tree, monkeypatch, capsys):
    root, _ = face_tree
    flax_model = JaxFaceNet(16)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 80, 80, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(9)))
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], optax.sgd(1e-3))
    mgr = JaxCheckpointManager(str(root / "jax_ckpt"))
    mgr.save(0, state)
    mgr.close()
    model = FaceNetModel(16, device="cpu")
    torch.save(flax_to_state_dict(variables, model), root / "model.pt")

    lfw_flags = ["--lfwDir", str(root / "lfw"), "--lfwPairs", str(root / "pairs.txt"),
                 "--imageSize", "80", "--embeddingSize", "16"]
    monkeypatch.setattr(sys, "argv", ["validate_on_lfw"] + lfw_flags
                        + ["--modelPath", str(root / "jax_ckpt")])
    jax_validate_cli.main()
    want = capsys.readouterr().out.strip().splitlines()[-4:]
    validate_on_lfw.main(lfw_flags + ["--modelPath", str(root / "model.pt"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-4:] == want

    images = sorted(str(p) for p in (root / "lfw").glob("*/*.jpg"))[:5]
    flags = ["--imageSize", "80", "--embeddingSize", "16"]
    monkeypatch.setattr(sys, "argv", ["facenet_distance"] + images + flags
                        + ["--modelPath", str(root / "jax_ckpt")])
    jax_distance_cli.main()
    want = capsys.readouterr().out.strip().splitlines()
    matrix = facenet_distance.main(images + flags + ["--modelPath", str(root / "model.pt"),
                                                     "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got[:2] == want[:2] and len(got) == len(want) == 7
    want_matrix = np.array([[float(v) for v in line.split()[1:]] for line in want[2:]])
    np.testing.assert_allclose(matrix, want_matrix, rtol=0, atol=1e-4)
    assert matrix.max() > 0


def test_cli_arguments_and_the_card(capsys):
    args = train_facenet.parse_args(["--filesPath", "f"])
    assert (args.device, args.backbone, args.embeddingSize, args.imageSize, args.batchSize,
            args.peoplePerBatch, args.imagesPerPerson, args.optimizer, args.emaDecay) == (
        "cuda", "InceptionResNetV1", 512, 160, 30, 45, 40, "ADAM", 0.9999)
    with pytest.raises(SystemExit):
        train_facenet.parse_args(["--filesPath", "f", "--optimizer", "SGD"])
    assert "invalid choice" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validate_on_lfw.main(["--lfwDir", "d", "--lfwPairs", "p", "--modelPath", "m"])
