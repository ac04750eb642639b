"""The greedy NMS sweep: the plain version against the TPU kernel, and the CUDA
kernel against the plain version.

- On the CPU, ``greedy_sweep_reference`` is held against the Pallas kernel
  ``greedy_sweep_pallas(..., interpret=True)``, as ``tests/test_nms_pallas.py``
  runs it, on score-sorted clustered boxes with tied scores, padding and
  zero-area boxes. The Pallas kernel's yxyx DIoU (``diou_std``) uses unclamped
  areas where ``ops/iou.py`` clamps, so that pair is compared on boxes that are
  not degenerate. Kept masks must be exactly equal.
- The kernel's two stages have plain versions too: ``scan_reference`` of
  ``suppression_mask_reference`` is held against ``greedy_sweep_reference`` and
  the Pallas kernel over N in {1, 63, 64, 65, 127, 1000} (word edges), all four
  variants, with and without classes; and ``ops.nms.nms`` / ``nms_by_classes``
  against ``nms_pallas(..., interpret=True)``, indices and valid masks equal.
- The ``cuda`` cases build the kernel and compare its kept masks with the plain
  version's on the card, exactly, over N in {1, 127, 128, 1000, 1024, 3000} and
  B in {1, 16}, and stage 1's mask with ``suppression_mask_reference`` word for
  word. They skip without a card; on the GPU host run them with
  ``python -m pytest tests/test_torch_nms_kernel.py -m cuda``. That host need not
  have the JAX package's dependencies, so jax is imported only inside the tests
  that compare with it.
"""

import numpy as np
import pytest
import torch

from tmv_tpu_torch.kernels import nms_sweep
from tmv_tpu_torch.kernels.nms_sweep import (
    greedy_sweep, greedy_sweep_reference, scan, scan_reference, suppression_mask,
    suppression_mask_reference, upper_words,
)
from tmv_tpu_torch.ops.nms import nms, nms_by_classes
from torch_port_cases import nms_case

# (coord, the port's iou_type, the Pallas kernel's iou_type on the same boxes)
VARIANTS = [("xyxy", "iou", "iou"), ("xyxy", "diou", "diou"),
            ("yxyx", "iou", "iou"), ("yxyx", "diou", "diou_std")]


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


def pallas_kept(boxes, eligible, classes, threshold, iou_type):
    import jax.numpy as jnp
    from tmv_tpu.kernels.nms_pallas import greedy_sweep_pallas

    return np.asarray(greedy_sweep_pallas(
        jnp.asarray(boxes[0]), jnp.asarray(eligible[0]),
        None if classes is None else jnp.asarray(classes[0]), threshold, iou_type,
        interpret=True))


@pytest.mark.parametrize("class_aware", [False, True], ids=["agnostic", "class_aware"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["-".join(v[:2]) for v in VARIANTS])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 1000])
def test_scan_of_mask_equals_sweep_and_pallas(n, variant, class_aware):
    """The two stages' plain versions compose to the sweep: on tied scores,
    ineligible padding and zero-area boxes against ``greedy_sweep_reference``
    (B = 2), and against the Pallas kernel (xyxy on the same boxes; yxyx, whose
    Pallas formulas differ on degenerate boxes, on boxes that are not)."""
    coord, iou_type, pallas_type = variant
    rng = np.random.default_rng(n)
    arrays = sorted_case(rng, n, batch=2, coord=coord)
    boxes, eligible, classes = (torch.from_numpy(a) for a in arrays)
    cls = classes if class_aware else None
    mask = suppression_mask_reference(boxes, cls, 0.45, iou_type, coord)
    assert mask.shape == (2, n, -(-n // 64)) and mask.dtype == torch.int64
    got = scan_reference(mask, eligible)
    assert torch.equal(got, greedy_sweep_reference(boxes, eligible, cls, 0.45, iou_type, coord))

    if coord == "yxyx":
        arrays = sorted_case(rng, n, batch=1, degenerate=False, coord=coord)
    boxes, eligible, classes = (torch.from_numpy(a) for a in arrays)
    cls = classes if class_aware else None
    got = scan_reference(suppression_mask_reference(boxes, cls, 0.45, iou_type, coord),
                         eligible)
    want = pallas_kept(arrays[0], arrays[1], arrays[2] if class_aware else None, 0.45,
                       pallas_type)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_scan_reference_ignores_undefined_words(rng):
    """The kernel leaves the words left of a row's own word unwritten; the scan
    must not read them."""
    boxes, eligible, classes = (torch.from_numpy(a) for a in sorted_case(rng, 300, batch=2))
    mask = suppression_mask_reference(boxes, classes, 0.5, "diou", "xyxy")
    defined = upper_words(300)
    garbage = torch.from_numpy(rng.integers(-2**62, 2**62, mask.shape))
    noisy = torch.where(defined, mask, garbage)
    assert not torch.equal(noisy, mask)
    assert torch.equal(scan_reference(noisy, eligible), scan_reference(mask, eligible))


@pytest.mark.parametrize("class_aware", [False, True], ids=["agnostic", "class_aware"])
@pytest.mark.parametrize("variant", VARIANTS, ids=["-".join(v[:2]) for v in VARIANTS])
def test_nms_matches_nms_pallas(variant, class_aware):
    """The port's whole NMS entry points (sort, sweep, compaction) against the
    TPU package's ``nms_pallas``: indices and valid masks exactly equal."""
    import jax.numpy as jnp
    from tmv_tpu.kernels.nms_pallas import nms_pallas

    coord, iou_type, pallas_type = variant
    rng = np.random.default_rng(11)
    boxes, scores, classes, valid = nms_case(rng, 300, zero_area=coord == "xyxy")
    if coord == "yxyx":
        boxes = np.ascontiguousarray(boxes[:, [1, 0, 3, 2]])
    kw = dict(max_output_size=100, iou_threshold=0.45, score_threshold=0.25)
    t = [torch.from_numpy(a) for a in (boxes, scores, classes, valid)]
    if class_aware:
        idx, ok = nms_by_classes(t[0], t[1], t[2], t[3], iou_type=iou_type, coord=coord, **kw)
    else:
        idx, ok = nms(t[0], t[1], t[3], iou_type=iou_type, coord=coord, **kw)
    want_idx, want_ok = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(classes) if class_aware else None,
                                   jnp.asarray(valid), iou_type=pallas_type, interpret=True,
                                   **kw)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(ok.sum()) > 5


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
            mask = suppression_mask(boxes, cls, 0.5, iou_type, coord)
            want_mask = suppression_mask_reference(boxes, cls, 0.5, iou_type, coord)
            defined = upper_words(n, cuda)
            assert torch.equal(mask[:, defined], want_mask[:, defined]), (n, batch)
            assert torch.equal(scan(mask, eligible), want), (n, batch)
            assert nms_sweep.launches == before + 1   # the stages alone do not count
