"""Data parallelism of the port's YOLO training path on gloo CPU ranks.

The YOLOv3 case of ``tests/torch_parallel_cases.py`` (@64 B8 with real targets and
the shadow loss, once with ``accum_steps=2``) runs under ``parallel.DataParallel`` over
2 ranks, each on its rows of the global batch, and in one process on the whole batch;
earlier slices' tests hold that one-process step to JAX's. The tolerances are
``tests/dp_equiv_cases.py``'s, whose comments say why (thresholded masks flip under
reduction-order noise). A control with the BatchNorm statistics made rank-local must
fail them: the tests see a local-instead-of-global fault. Also the mesh's
``shard_batch`` and ``replicate`` on the ranks, and ``shard_rows``' error;
``train_efficientdet --dp`` in the ranks, and ``--fsdp`` in this process while the
ranks run. D0 (and its control),
FaceNet and MoCo are in ``test_torch_parallel_fsdp.py``.
"""

import pytest
import torch

import torch_parallel_cases as cases
from torch_port_cases import write_tiny_set

NAMES = ("yolo", "yolo_accum")


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The ranks, started before the first test of the module, and a tiny train set;
    this process keeps 2 CPU threads meanwhile."""
    root = tmp_path_factory.mktemp("dp_ranks")
    files = write_tiny_set(root)
    with cases.threads(2):
        yield {"ranks": cases.Ranks("paths_worker", 2, root, NAMES, ("yolo_local_bn",),
                                    (files, str(root))),
               "files": files, "root": root}


def test_train_efficientdet_fsdp_runs_in_a_group_of_one(ranks, tmp_path):
    """``train_efficientdet --fsdp`` (D0 @32, ``--deviceAug``, B2, two steps) on the
    CPU while the ranks run: this process is the group's one rank, the group is gone
    after; the checkpoint, gathered whole, loads into a plain module. (Both trainers'
    ``--dp``/``--fsdp`` run at full width on the card, ``chip_smoke.py`` phase 25.)"""
    from tmv_tpu_torch.cli import train_efficientdet
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet

    files = ranks["files"]
    got = train_efficientdet.main([
        "--trainData", files["labels"], "--trainImagePath", files["images"], "--classesFile",
        files["classes"], "--imageSize", "32", "--batchSize", "2", "--stepsPerEpoch", "2",
        "--epochs", "1", "--device", "cpu", "--modelName", "efficientdet-d0", "--deviceAug",
        "--fsdp", "--modelPath", str(tmp_path / "d0")])
    assert got["step"] == 2
    assert not torch.distributed.is_initialized()
    model, _ = build_efficientdet("efficientdet-d0", 4, 32, device="cpu")
    assert load_weights(model, str(tmp_path / "d0")) == 2


@pytest.fixture(scope="module")
def runs(ranks):
    """(one-process snapshots, each rank's snapshots) of every case; the references
    run here while the ranks run."""
    try:
        refs = {name: cases.run_case(name) for name in NAMES}
    finally:
        results = ranks["ranks"].results()
    return refs, results


def test_shard_batch_takes_this_ranks_rows(runs):
    """Rank r holds rows [4r, 4r + 4) of 8; with 2 micro-batches rows [2r, 2r + 2) of
    each half; nested tuples and numpy arrays alike."""
    for r, result in enumerate(runs[1]):
        shard, accum = result["mesh"]["shard"], result["mesh"]["accum"]
        assert shard["x"].tolist() == list(range(4 * r, 4 * r + 4))
        assert shard["y"][0].tolist() == [10 * i for i in range(4 * r, 4 * r + 4)]
        assert accum["x"].tolist() == [2 * r, 2 * r + 1, 4 + 2 * r, 5 + 2 * r]


def test_shard_rows_raises_jax_error_on_an_indivisible_batch():
    from tmv_tpu_torch.parallel.mesh import shard_rows

    assert shard_rows(8, 1, 2) == [4, 5, 6, 7]
    for b, accum in ((7, 1), (6, 2)):
        with pytest.raises(ValueError, match="should be divisible by"):
            shard_rows(b, 0, 2, accum)


def test_replicate_makes_every_rank_rank_zeros(runs):
    """A module's parameters and buffers and a nested dict of tensors equal rank 0's
    on every rank, exactly."""
    for result in runs[1]:
        mesh = result["mesh"]
        assert torch.equal(mesh["module"]["weight"], torch.ones(3))
        assert torch.equal(mesh["module"]["running_mean"], torch.full((3,), 2.0))
        assert torch.equal(mesh["tensors"]["a"], torch.zeros(3))
        assert torch.equal(mesh["tensors"]["b"][0], torch.full((2,), 5.0))


@pytest.mark.parametrize("name", NAMES + ("yolo_local_bn",))
def test_ranks_hold_one_state(runs, name):
    cases.check_ranks_hold_one_state(runs[1], name)


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_equals_the_one_process_step(runs, name):
    cases.check_dp_step_equals_the_one_process_step(runs[0][name][-1], runs[1][0][name][-1])


def test_rank_local_batchnorm_fails_the_tolerance(runs):
    """With the BatchNorm statistics rank-local the YOLOv3 step is out of tolerance."""
    cases.check_control_fails_the_tolerance(runs[0]["yolo"][-1],
                                            runs[1][0]["yolo_local_bn"][-1])


def test_trainer_cli_runs_in_two_ranks(ranks, runs):
    """``train_efficientdet --dp`` in the 2 ranks, as under torchrun: rank 0 alone
    returns (step 1) and logs (one line); one checkpoint, in the single-device format,
    loads into a plain module."""
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet

    out = [r["d0_cli"] for r in runs[1]]
    assert out[0]["step"] == 1 and out[1] is None
    directory = ranks["root"] / "d0"
    assert sorted(p.name for p in directory.iterdir()) == ["1.pt", "metrics.jsonl"]
    assert len((directory / "metrics.jsonl").read_text().splitlines()) == 1
    model, _ = build_efficientdet("efficientdet-d0", 4, 32, device="cpu")
    assert load_weights(model, str(directory)) == 1
