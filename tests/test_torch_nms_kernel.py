"""The greedy NMS sweep: the plain version against the TPU kernel, and the CUDA
kernel against the plain version.

- On the CPU, ``greedy_sweep_reference`` is held against the Pallas kernel
  ``greedy_sweep_pallas(..., interpret=True)``, as ``tests/test_nms_pallas.py``
  runs it, on score-sorted clustered boxes with tied scores, padding and
  zero-area boxes. The Pallas kernel's yxyx DIoU (``diou_std``) uses unclamped
  areas where ``ops/iou.py`` clamps, so that pair is compared on boxes that are
  not degenerate. Kept masks must be exactly equal.
- The ``cuda`` cases build the kernel and compare its kept masks with the plain
  version's on the card, exactly, over N in {1, 127, 128, 1000, 1024, 3000} and
  B in {1, 16}. They skip without a card; on the GPU host run them with
  ``python -m pytest tests/test_torch_nms_kernel.py -m cuda``. That host need not
  have the JAX package's dependencies, so jax is imported only inside the tests
  that compare with it.
"""

import numpy as np
import pytest
import torch

from tmv_tpu_torch.kernels import nms_sweep
from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep, greedy_sweep_reference
from torch_port_cases import nms_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def sorted_case(rng, n, batch=1, degenerate=True, coord="xyxy"):
    """Sweep inputs (B, N, 4) boxes, (B, N) eligible, (B, N) classes, sorted
    by descending score with ties kept in index order."""
    boxes, eligible, classes = [], [], []
    for _ in range(batch):
        b, s, c, v = nms_case(rng, n, zero_area=degenerate)
        order = np.argsort(-np.where(v, s, -np.inf), kind="stable")
        b = b[order]
        boxes.append(b[:, [1, 0, 3, 2]] if coord == "yxyx" else b)
        eligible.append((v & (s >= 0.25))[order])
        classes.append(c[order])
    return (np.ascontiguousarray(np.stack(boxes), np.float32), np.stack(eligible),
            np.stack(classes).astype(np.int32))


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("iou_type", ["iou", "diou"])
def test_reference_matches_pallas_xyxy(rng, class_aware, iou_type):
    import jax.numpy as jnp
    from tmv_tpu.kernels.nms_pallas import greedy_sweep_pallas

    boxes, eligible, classes = sorted_case(rng, 200)
    cls = classes if class_aware else None
    want = greedy_sweep_pallas(jnp.asarray(boxes[0]), jnp.asarray(eligible[0]),
                               None if cls is None else jnp.asarray(cls[0]),
                               0.45, iou_type, interpret=True)
    got = greedy_sweep_reference(torch.from_numpy(boxes), torch.from_numpy(eligible),
                                 None if cls is None else torch.from_numpy(cls),
                                 0.45, iou_type, "xyxy")
    assert got.shape == (1, 200) and got.dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert 5 < int(got.sum()) < int(eligible.sum())


@pytest.mark.parametrize("class_aware", [False, True])
def test_reference_yxyx_diou_matches_pallas_diou_std(rng, class_aware):
    import jax.numpy as jnp
    from tmv_tpu.kernels.nms_pallas import greedy_sweep_pallas

    boxes, eligible, classes = sorted_case(rng, 200, degenerate=False, coord="yxyx")
    cls = classes if class_aware else None
    want = greedy_sweep_pallas(jnp.asarray(boxes[0]), jnp.asarray(eligible[0]),
                               None if cls is None else jnp.asarray(cls[0]),
                               0.45, "diou_std", interpret=True)
    got = greedy_sweep_reference(torch.from_numpy(boxes), torch.from_numpy(eligible),
                                 None if cls is None else torch.from_numpy(cls),
                                 0.45, "diou", "yxyx")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    boxes, eligible, classes = (torch.from_numpy(a) for a in sorted_case(rng, 130, batch=3))
    before = nms_sweep.launches
    got = greedy_sweep(boxes, eligible, classes, 0.5, "diou", "xyxy")
    want = greedy_sweep_reference(boxes, eligible, classes, 0.5, "diou", "xyxy")
    assert torch.equal(got, want)
    assert nms_sweep.launches == before          # no kernel ran


def test_wrapper_refuses_other_devices_and_variants():
    boxes = torch.zeros((1, 8, 4), device="meta")
    eligible = torch.zeros((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        greedy_sweep(boxes, eligible, None, 0.5)
    with pytest.raises(ValueError, match="unsupported"):
        greedy_sweep(torch.zeros((1, 8, 4)), torch.zeros((1, 8), dtype=torch.bool), None,
                     0.5, "ciou")


@pytest.mark.cuda
@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("coord", ["xyxy", "yxyx"])
@pytest.mark.parametrize("iou_type", ["iou", "diou"])
def test_kernel_matches_reference_on_card(cuda, class_aware, coord, iou_type):
    rng = np.random.default_rng(7)
    for n in (1, 127, 128, 1000, 1024, 3000):
        for batch in (1, 16):
            arrays = sorted_case(rng, n, batch=batch, coord=coord)
            boxes, eligible, classes = (torch.from_numpy(a).to(cuda) for a in arrays)
            cls = classes if class_aware else None
            before = nms_sweep.launches
            got = greedy_sweep(boxes, eligible, cls, 0.5, iou_type, coord)
            assert nms_sweep.launches == before + 1
            want = greedy_sweep_reference(boxes, eligible, cls, 0.5, iou_type, coord)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, batch)
