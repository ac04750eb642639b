"""Data parallelism of the port's embedding steps, FaceNet and MoCo, on gloo CPU ranks.

The FaceNet triplet step with ``valid`` (RepVGG-B2g4 @64, B8) and two MoCo steps
(ResNetYoloV3 @32, B8, queue 32) of ``tests/torch_parallel_cases.py`` under
``parallel.DataParallel`` over 2 ranks against one process on the whole batch, at
``tests/dp_equiv_cases.py``'s sizes and tolerances (mining and InfoNCE reroute
gradients under reduction-order noise: the parameters are a gross band, the loss and
the queue the discriminating checks).
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases

PATHS = ("facenet", "moco")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process snapshots, each rank's snapshots); the references run here while
    the ranks run."""
    ranks = cases.Ranks("paths_worker", 2, tmp_path_factory.mktemp("embed_ranks"), PATHS)
    try:
        with cases.threads(2):
            refs = {name: cases.run_case(name) for name in PATHS}
    finally:
        results = ranks.results()
    return refs, results


@pytest.mark.parametrize("name", PATHS)
def test_ranks_hold_one_state(runs, name):
    cases.check_ranks_hold_one_state(runs[1], name)


def test_facenet_triplet_step_with_valid(runs):
    """The valid triplets counted over the global batch: loss within rel 2e-3,
    parameters in ``case_facenet``'s gross band (rtol 1, atol 3e-4)."""
    ref, got = runs[0]["facenet"][-1], runs[1][0]["facenet"][-1]
    assert got["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"], rel=2e-3)
    for key, value in cases.floats(ref["model"]).items():
        np.testing.assert_allclose(got["model"][key].numpy(), value.numpy(), rtol=1.0,
                                   atol=3e-4, err_msg=key)


def test_moco_step_one_enqueues_the_global_keys_in_rank_order(runs):
    """Step 1: loss within rel 1e-3, the queue pointer exactly, the queue's rows within
    rtol 1e-3, atol 1e-5 (rank 0's keys, then rank 1's); at warm-up decay 0 the key
    tower equals the DP run's own query tower exactly; across runs the key tower in
    ``case_moco``'s gross band (rtol 1, atol 2e-2)."""
    ref, got = runs[0]["moco"][0], runs[1][0]["moco"][0]
    assert got["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"], rel=1e-3)
    assert got["queue_ptr"] == ref["queue_ptr"] == 8
    np.testing.assert_allclose(got["queue"].numpy(), ref["queue"].numpy(), rtol=1e-3,
                               atol=1e-5)
    for key, value in cases.floats(got["key_model"]).items():
        assert torch.equal(value, got["model"][key]), key
        np.testing.assert_allclose(value.numpy(), ref["key_model"][key].numpy(), rtol=1.0,
                                   atol=2e-2, err_msg=key)


def test_moco_step_two_keeps_the_structure(runs):
    """Step 2 (chaotic): the pointer exactly, step 1's rows untouched by the second
    push (rtol 1e-3, atol 1e-5), the loss within rel 5e-2."""
    ref, got = runs[0]["moco"][1], runs[1][0]["moco"][1]
    assert got["queue_ptr"] == ref["queue_ptr"] == 16
    np.testing.assert_allclose(got["queue"][:8].numpy(), ref["queue"][:8].numpy(), rtol=1e-3,
                               atol=1e-5)
    assert got["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"], rel=5e-2)


