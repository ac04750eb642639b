"""``SpatialDataParallel`` steps on gloo CPU ranks against one process and against JAX.

The ranks (``torch_spatial_cases.Ranks``, spawned, 2 CPU threads each) run the cases of
``torch_parallel_cases`` under ``SpatialDataParallel`` on their share of the global
batch (``put_batch``: data rows, and the height rows of every leaf the space axis
divides): a 1 x 2 mesh (2 ranks) and a 2 x 2 mesh (4 ranks). Meanwhile this process
runs the same cases on the whole batch, and JAX's single-device step on the ConvBN
stack.

- the ConvBN stack (16 px, B8, two SGD steps) on both meshes and D0 @64 B4 on the
  2 x 2 (SGD,
  clip, EMA, ``drop_connect``; the l2 term counted once over space; its 1-row P6 and
  P7 levels run gathered, with partial gradients and BatchNorm statistics over the
  data axis) equal the one-process step by
  ``torch_parallel_cases.check_dp_step_equals_the_one_process_step`` (loss within rel
  2e-3, every parameter and running statistic within rtol 1e-3, atol 5e-4), and
  every rank ends with the same state;
- the ConvBN stack's parameters and running statistics after two steps equal JAX's
  single-device ``make_train_step`` within 1e-5·max|ref| of each leaf;
- YOLOv3 @64 B8 (the shadow loss, the 2-row stride-32 level, real grid targets read
  whole by the loss) on the 1 x 2 mesh equals the one-process step by the same rule;
  the control, the same case with the gradients averaged over the space ranks (DDP's
  default mean over every rank) where they must be summed, fails the tolerance;
- ``wrap_forward`` on a rank's share of the stack's batch returns the whole outputs of
  its data rows on every rank (within 1e-5 of one process's forward);
- ``train_yolo --sp 2`` (YOLOv4 @64, global B2, one step) and ``train_efficientdet --sp
  2`` (D0 @64) in two ranks of their own, as under torchrun: their loss equals
  the plain one-process CLI's (rel 2e-3, ``torch_parallel_cases``'s loss tolerance) and
  rank 0 writes the checkpoint. (At 32 px YOLOv4's train-mode BatchNorms normalise 2
  values per channel at the 1 x 1 level, which turns the shards' rounding differences
  into sign flips: a size the comparison cannot use.)
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import torch_parallel_cases as cases
import torch_spatial_cases as sc
from tmv_tpu.core.train_state import TrainState as JaxTrainState
from tmv_tpu.core.train_state import make_train_step as jax_train_step
from tmv_tpu.models.layers.common import ConvBN as FlaxConvBN
from tmv_tpu_torch.cli import train_efficientdet, train_yolo
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict, state_dict_to_flax
from torch_port_cases import write_tiny_set

NAMES = ("convbn", "yolo", "d0")
# each mesh's ranks and cases: the 1 x 2 mesh with YOLOv3 and its control, the 2 x 2 with
# D0; the trainers' CLIs run in two ranks of their own beside them
MESHES = {"1x2": (2, ("convbn", "yolo")), "2x2": (4, ("convbn", "d0"))}
CASES = [(mesh, name) for mesh, (_, names) in sorted(MESHES.items()) for name in names]


class FlaxStack(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = FlaxConvBN(16, 3)(x, train)
        return FlaxConvBN(32, 3, strides=2)(x, train)


def jax_convbn():
    """Two SGD 0.1 steps of the flax stack on one device, from the port's seed-0
    weights → the port's ``state_dict`` layout."""
    model = FlaxStack()
    variables = state_dict_to_flax(cases.init_convbn().state_dict())
    tx = optax.sgd(0.1)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)

    def loss_fn(params, batch_stats, batch, rng):
        y, new = model.apply({"params": params, "batch_stats": batch_stats}, batch["image"],
                             train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.square(y - batch["target"])), (new["batch_stats"], {})

    step = jax.jit(jax_train_step(loss_fn, tx))
    for batch in cases.convbn_batches():
        state, _ = step(state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    return flax_to_state_dict({"params": jax.device_get(state.params),
                               "batch_stats": jax.device_get(state.batch_stats)})


def cli_argv(files, root, which):
    """A trainer's argv at 64 px, global B2, one step, on the CPU (``which`` "yolo":
    YOLOv4, or "d0")."""
    common = ["--trainData", files["labels"], "--trainImagePath", files["images"],
              "--classesFile", files["classes"], "--imageSize", "64", "--batchSize", "2",
              "--stepsPerEpoch", "1", "--epochs", "1", "--device", "cpu",
              "--earlyStopPatience", "0", "--modelPath", f"{root}/{which}"]
    if which == "yolo":
        return common + ["--anchorsFile", files["anchors"], "--reduceLrPatience", "0"]
    return common + ["--modelName", "efficientdet-d0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's rank results and two ranks' runs of both trainers' ``--sp 2`` CLIs
    (as under torchrun), and here meanwhile the one-process references, JAX's
    ConvBN step and the plain CLIs."""
    root = tmp_path_factory.mktemp("spatial_ranks")
    files = write_tiny_set(root)
    for label in MESHES:
        (root / label).mkdir()
    clis = [(w, cli_argv(files, root / "sp", w) + ["--sp", "2"]) for w in ("yolo", "d0")]
    ranks = {label: sc.Ranks(world, root / label, 2, names,
                             ("yolo_averaged",) if world == 2 else ())
             for label, (world, names) in MESHES.items()}
    (root / "cli").mkdir()
    ranks["cli"] = sc.Ranks(2, root / "cli", 2, (), (), clis)
    try:
        with cases.threads(2):
            refs = {name: cases.run_case(name) for name in NAMES}
            jax_ref = jax_convbn()
            plain = {"yolo": train_yolo.main(cli_argv(files, root / "plain", "yolo")),
                     "d0": train_efficientdet.main(cli_argv(files, root / "plain", "d0"))}
    finally:
        results = {label: r.results() for label, r in ranks.items()}
    return refs, jax_ref, results, (root, plain)


def test_the_ranks_lay_out_data_by_space(runs):
    _, _, results, _ = runs
    assert [r["mesh"] for r in results["1x2"]] == [(0, 0, 1), (0, 1, 1)]
    assert [r["mesh"] for r in results["2x2"]] == [(0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_wrap_forward_returns_the_whole_outputs_of_a_ranks_rows(runs, mesh):
    _, _, results, _ = runs
    model = cases.init_convbn().eval()
    images = torch.from_numpy(cases.convbn_batches()[0]["image"])
    with torch.no_grad():
        want = model(images)
    for result in results[mesh]:
        data_rank, _, data_world = result["mesh"]
        rows = len(images) // data_world
        torch.testing.assert_close(result["forward"], want[data_rank * rows:(data_rank + 1) * rows],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh, name", CASES)
def test_sp_step_equals_the_one_process_step(runs, mesh, name):
    refs, _, results, _ = runs
    for ref, got in zip(refs[name], results[mesh][0][name]):
        cases.check_dp_step_equals_the_one_process_step(ref, got)
    for other in results[mesh][1:]:    # every rank holds one state
        assert other[name][-1]["digest"] == results[mesh][0][name][-1]["digest"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sp_convbn_equals_the_jax_step(runs, mesh):
    _, jax_ref, results, _ = runs
    got = results[mesh][0]["convbn"][-1]["model"]
    for key, want in jax_ref.items():
        want = torch.as_tensor(np.asarray(want))
        if not want.is_floating_point():     # the port's step counters
            continue
        scale = float(want.abs().max()) or 1.0
        assert float((got[key] - want).abs().max()) <= 1e-5 * scale, key


def test_gradients_averaged_over_space_fail_the_tolerance(runs):
    refs, _, results, _ = runs
    cases.check_control_fails_the_tolerance(refs["yolo"][0],
                                            results["1x2"][0]["yolo_averaged"][0])


def first_loss(directory):
    with open(f"{directory}/metrics.jsonl") as f:
        return json.loads(f.readline())["loss"]


@pytest.mark.parametrize("which", ["yolo", "d0"])
def test_trainer_sp_equals_the_plain_cli(runs, which):
    _, _, results, (root, plain) = runs
    sharded = results["cli"]
    assert sharded[0][f"cli_{which}"]["step"] == plain[which]["step"] == 1
    assert sharded[1][f"cli_{which}"] is None        # rank 0 alone returns and writes
    assert (root / "sp" / which / "1.pt").exists()
    assert first_loss(root / "sp" / which) == pytest.approx(
        first_loss(root / "plain" / which), rel=2e-3)
