"""The port's distillation and MoCo CLIs and their pieces against the JAX package.

- The pseudo-labeler on the three-scale stand-in of ``tests/test_moco_distill.py``
  (2 classes, 64 px, B = 3), fed JAX's per-image confidence draws: JAX's class
  ids and valid mask exactly and its pixel boxes within 1e-4 px. One head's
  class rows have zero weights, so its candidates' scores tie; the labeler
  runs one sweep for the batch.
- ``promote_teacher`` copies what JAX's copies; ``graft_params`` on the
  bridged ``state_dict``\\ s copies and skips JAX's names (mapped through the
  bridge; the port's BatchNorm step counters are copied besides) and grafts
  JAX's values.
- One run of each CLI mode at ``--imageSize 64 --device cpu`` on the port's
  full-width ``ResNetYoloV3``: ``train_moco`` pretrain (and a resume that
  continues the step, the queue pointer and the key tower), ``export_k`` (a
  weights-only checkpoint equal to the key tower), ``finetune`` (exactly the
  three output convs' 6 tensors skipped); ``train_distill`` train_teacher,
  promote (the teacher equals the student), dump_labels (lines in JAX's format
  equal to the labeler's output for the same seed, on a seeded teacher whose
  output convs are scaled so that it detects) and train_students.
"""

import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmv_tpu.convert.graft import graft_params as jax_graft_params
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.models.distill import make_pseudo_label_fn as jax_pseudo_label_fn
from tmv_tpu.models.distill import promote_teacher as jax_promote_teacher
from tmv_tpu_torch.cli import train_distill, train_moco
from tmv_tpu_torch.convert import flax_bridge
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.convert.graft import graft_params
from tmv_tpu_torch.core.checkpoint import CheckpointManager, read_weights
from tmv_tpu_torch.data.loaders import load_anchors, load_classes
from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep
from tmv_tpu_torch.models.distill import make_pseudo_label_fn, promote_teacher
from tmv_tpu_torch.models.layers.common import init_weights
from tmv_tpu_torch.models.moco import ResNetYoloV3
from torch_port_cases import seeded_variables, tiny_flax_detector, tiny_torch_detector
from torch_port_cases import write_tiny_set
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]], [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32)
CLASSES, SIZE = 2, 64


def labeler_variables(rng):
    """Seeded stand-in variables: box rows small, objectness around 0.4, and
    the stride-8 head's class rows only a bias (tied scores)."""
    model = tiny_flax_detector(3 * (5 + CLASSES))
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    rows = np.arange(3 * (5 + CLASSES)) % (5 + CLASSES)
    for head in ("Conv_1", "Conv_3", "Conv_5"):
        kernel, bias = variables["params"][head]["kernel"], variables["params"][head]["bias"]
        kernel[..., rows < 4] *= 0.1
        bias[rows < 4] = 0.0
        bias[rows == 4] = -0.4
        if head == "Conv_1":
            kernel[..., rows >= 5] = 0.0
            bias[rows >= 5] = np.tile([0.5, 1.0], 3).astype(np.float32)
    return model, variables


def test_labeler_equals_jax_fed_its_draws():
    rng = np.random.default_rng(0)
    model, variables = labeler_variables(rng)
    images = rng.uniform(0, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.key(7)
    labeler = jax_pseudo_label_fn(model, ANCHORS, (SIZE, SIZE), CLASSES)
    want = [np.asarray(t) for t in labeler(variables, jnp.asarray(images), key)]
    conf = np.array([float(jax.random.uniform(k, (), minval=0.3, maxval=0.5))
                     for k in jax.random.split(key, 3)], np.float32)

    net = tiny_torch_detector(3 * (5 + CLASSES))
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    calls = []

    def counted(*args):
        calls.append(args[0].shape[0])
        return greedy_sweep(*args)

    with mock.patch("tmv_tpu_torch.ops.nms.greedy_sweep", counted):
        got = make_pseudo_label_fn(net, ANCHORS, (SIZE, SIZE), CLASSES)(
            torch.from_numpy(images), conf=torch.from_numpy(conf))
    got = [t.numpy() for t in got]
    assert calls == [3]                      # one sweep labels the batch
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    valid = want[2]
    assert valid.shape == (3, 100) and (valid.sum(1) >= 1).all()
    # tied scores among the kept rows: the stride-8 head's class scores are equal
    heads = model.apply(variables, jnp.asarray(images))
    scores = 1 / (1 + np.exp(-np.asarray(heads[2]).reshape(3, -1, 5 + CLASSES)[..., 5:]))
    assert len(np.unique(scores.max(-1))) <= 3
    # a generator draws thresholds in [0.3, 0.5) itself
    gen = torch.Generator().manual_seed(0)
    boxes, ids, ok = make_pseudo_label_fn(net, ANCHORS, (SIZE, SIZE), CLASSES)(
        torch.from_numpy(images), generator=gen)
    assert boxes.shape == (3, 100, 4) and ids.dtype == torch.int32 and ok.dtype == torch.bool


def test_promote_teacher_and_graft_match_jax():
    rng = np.random.default_rng(1)
    x0 = jnp.zeros((1, 32, 32, 3))

    def variables_of(out_filters):
        model = tiny_flax_detector(out_filters)
        shapes = jax.eval_shape(model.init, jax.random.key(0), x0)
        return jax.tree.map(np.asarray, seeded_variables(shapes, rng))

    student_vars, teacher_vars = variables_of(21), variables_of(21)
    jax_student = JaxTrainState.create(student_vars["params"], student_vars["batch_stats"],
                                       optax.adam(1e-3))
    promoted = jax_promote_teacher(jax_student, teacher_vars)
    student, teacher = tiny_torch_detector(21), tiny_torch_detector(21)
    student.load_state_dict(flax_to_state_dict(student_vars, student))
    teacher.load_state_dict(flax_to_state_dict(teacher_vars, teacher))
    got = promote_teacher(student, teacher).state_dict()
    for name, want in flax_to_state_dict(promoted, teacher).items():
        assert torch.equal(got[name], want), name

    dst, src = variables_of(33), variables_of(21)
    want_tree, copied, skipped = {}, set(), set()
    for col in ("params", "batch_stats"):
        want_tree[col], c, s = jax_graft_params(dst[col], src[col])
        copied |= {flax_bridge._map_leaf(col, p)[0] for p in c}
        skipped |= {flax_bridge._map_leaf(col, p)[0] for p in s}
    model = tiny_torch_detector(33)
    grafted, got_copied, got_skipped = graft_params(flax_to_state_dict(dst, model),
                                                    flax_to_state_dict(src))
    assert {n for n in got_copied if not n.endswith("num_batches_tracked")} == copied
    assert set(got_skipped) == skipped and len(skipped) == 6
    for name, want in flax_to_state_dict(want_tree, model).items():
        assert torch.equal(grafted[name], want), name


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def cli_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    files = write_tiny_set(root, count=4, size=SIZE)
    yield root, files
    shutil.rmtree(root, ignore_errors=True)


def common(files):
    return ["--trainImagePath", files["images"], "--batchSize", "2", "--imageSize", str(SIZE),
            "--device", "cpu"]


@pytest.fixture(scope="module")
def moco_runs(cli_set):
    root, files = cli_set
    base = common(files) + ["--queueSize", "4", "--modelPath", str(root / "moco"),
                            "--exportPath", str(root / "moco_k")]
    first = train_moco.main(["--mode", "pretrain", "--steps", "2"] + base)
    saved = torch.load(CheckpointManager(str(root / "moco")).path(2), weights_only=True)
    resumed = train_moco.main(["--mode", "pretrain", "--steps", "3"] + base)
    exported = train_moco.main(["--mode", "export_k"] + base)
    tuned = train_moco.main(["--mode", "finetune", "--steps", "2", "--trainData",
                             files["labels"], "--classesFile", files["classes"],
                             "--anchorsFile", files["anchors"], "--modelPath",
                             str(root / "moco_det"), "--exportPath", str(root / "moco_k")]
                            + common(files))
    return root, first, saved, resumed, exported, tuned


def test_train_moco_pretrain_and_resume(moco_runs):
    root, first, saved, resumed, _, _ = moco_runs
    assert first["step"] == 2 and len(first["losses"]) == 2
    assert first["feature_dim"] == (2 ** 2 + 4 ** 2 + 8 ** 2) * 21
    assert np.isfinite(first["losses"]).all()
    assert saved["extra"]["queue_ptr"] == 4 % 4 and saved["extra"]["queue"].shape == (4, 1764)
    assert resumed["step"] == 3 and len(resumed["losses"]) == 1
    last = torch.load(CheckpointManager(str(root / "moco")).path(3), weights_only=True)
    assert last["extra"]["queue_ptr"] == 2
    moved = [not torch.equal(last["extra"]["key_model"][k], v)
             for k, v in saved["extra"]["key_model"].items() if v.is_floating_point()]
    assert any(moved)


def test_train_moco_export_k(moco_runs):
    root, _, _, _, exported, _ = moco_runs
    assert exported["step"] == 3
    weights, step = read_weights(str(root / "moco_k"))
    key = torch.load(CheckpointManager(str(root / "moco")).path(3),
                     weights_only=True)["extra"]["key_model"]
    assert step == 3 and weights.keys() == key.keys()
    assert all(torch.equal(weights[k], key[k]) for k in key)


def test_train_moco_finetune_grafts_all_but_the_output_convs(moco_runs):
    root, _, _, _, _, tuned = moco_runs
    assert tuned["step"] == 2 and np.isfinite(tuned["losses"]).all()
    assert sorted(tuned["skipped"]) == sorted(f"DarknetConv_{i}.Conv_0.{p}" for i in range(3)
                                              for p in ("weight", "bias"))
    assert CheckpointManager(str(root / "moco_det")).latest_step() == 2


def seeded_teacher(path, files):
    """A seeded ResNetYoloV3 whose output convs are scaled to logits of at most
    1, the objectness and class biases at +2 (every candidate valid), saved as
    a ``.pt``."""
    _, classes_num = load_classes(files["classes"])
    model = ResNetYoloV3(3 * (5 + classes_num), device="cpu")
    init_weights(model, 0)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        top = max(float(h.abs().max()) for h in model.eval()(images))
        rows = torch.arange(3 * (5 + classes_num)) % (5 + classes_num)
        for i in range(3):
            conv = getattr(model, f"DarknetConv_{i}").Conv_0
            conv.weight.mul_(1.0 / top)
            conv.bias.copy_(torch.where(rows >= 4, 2.0, 0.0))
    torch.save(model.state_dict(), path)
    return model


@pytest.fixture(scope="module")
def distill_runs(cli_set):
    root, files = cli_set
    base = common(files) + ["--classesFile", files["classes"], "--anchorsFile",
                            files["anchors"]]
    teacher = train_distill.main(["--mode", "train_teacher", "--trainData", files["labels"],
                                  "--steps", "2", "--teacherPath", str(root / "teacher")]
                                 + base)
    seeded = seeded_teacher(str(root / "seeded.pt"), files)
    dump = train_distill.main(["--mode", "dump_labels", "--teacherPath",
                               str(root / "seeded.pt"), "--labelsOut",
                               str(root / "pseudo.txt"), "--batchSize", "3", "--seed", "5"]
                              + base[:2] + base[4:])
    students = train_distill.main(["--mode", "train_students", "--steps", "2", "--teacherPath",
                                   str(root / "seeded.pt"), "--studentPath",
                                   str(root / "student")] + base)
    promote = train_distill.main(["--mode", "promote", "--studentPath", str(root / "student"),
                                  "--teacherPath", str(root / "promoted")] + base)
    return root, files, teacher, seeded, dump, students, promote


def test_train_distill_train_teacher(distill_runs):
    root, _, teacher, *_ = distill_runs
    assert teacher["step"] == 2 and np.isfinite(teacher["losses"]).all()
    assert CheckpointManager(str(root / "teacher")).latest_step() == 2


def test_train_distill_dump_labels_in_jax_format(distill_runs):
    root, files, _, seeded, dump, *_ = distill_runs
    classes_name, classes_num = load_classes(files["classes"])
    names = sorted(os.listdir(files["images"]))
    labeler = make_pseudo_label_fn(seeded, load_anchors(files["anchors"]), (SIZE, SIZE),
                                   classes_num)
    gen = torch.Generator().manual_seed(5)
    want = []
    for start in range(0, len(names), 3):
        chunk = names[start:start + 3]
        images = torch.from_numpy(train_distill.staged_images(
            [os.path.join(files["images"], n) for n in chunk], (SIZE, SIZE)))
        boxes, ids, valid = labeler(images, generator=gen)
        for pi, name in enumerate(chunk):
            parts = [name]
            v = valid[pi].numpy()
            for b, c in zip(boxes[pi].numpy()[v], ids[pi].numpy()[v]):
                parts.append(f"{classes_name[int(c)]},{b[0]:.1f},{b[1]:.1f},"
                             f"{b[2]:.1f},{b[3]:.1f}")
            want.append("|".join(parts) + "|\n")
    with open(root / "pseudo.txt", encoding="utf-8") as f:
        got = f.readlines()
    assert got == want and dump["lines"] == 4 and dump["boxes"] >= 4


def test_train_distill_train_students_and_promote(distill_runs):
    root, _, _, _, _, students, promote = distill_runs
    assert students["step"] == 2 and np.isfinite(students["losses"]).all()
    student, _ = read_weights(str(root / "student"))
    promoted, step = read_weights(promote["path"])
    assert step == 0 and all(torch.equal(promoted[k], v) for k, v in student.items())
