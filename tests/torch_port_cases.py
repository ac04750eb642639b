"""Seeded inputs shared by the PyTorch port's tests (``test_torch_*.py``).

Everything is made with numpy from a seed and handed to both the JAX function
and its port as numpy arrays. jax is imported only where a helper needs it, so
that the CUDA cases can run on a GPU host without the JAX package's
dependencies.
"""

import numpy as np
import pytest


def cluster_boxes(rng, n, coord="xyxy"):
    """Overlapping boxes around n/4 centres (as ``tests/test_nms_pallas.py``)."""
    centers = rng.uniform(10, 90, size=(n // 4 + 1, 2))
    idx = rng.integers(0, len(centers), size=n)
    c = centers[idx] + rng.normal(0, 3, size=(n, 2))
    wh = rng.uniform(5, 25, size=(n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1).astype(np.float32)
    return boxes[:, [1, 0, 3, 2]] if coord == "yxyx" else boxes


def nms_case(rng, n, classes_num=3, zero_area=True, tied=True):
    """Boxes, scores (rounded so that ties occur), classes and a padding mask."""
    boxes = cluster_boxes(rng, n)
    if zero_area:
        flat = rng.uniform(size=n) < 0.1
        boxes[flat, 2] = boxes[flat, 0]
    scores = rng.uniform(0, 1, size=n).astype(np.float32)
    if tied:
        scores = np.round(scores * 8) / 8
    classes = rng.integers(0, classes_num, size=n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    return boxes, scores.astype(np.float32), classes, valid


def seeded_variables(shapes, rng):
    """Fill a flax ``eval_shape`` tree: He-uniform kernels, and non-trivial BN
    scale/bias/mean/var so that the BatchNorm mapping is really exercised."""
    import jax

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.05, s.shape).astype(np.float32)
        limit = np.sqrt(6.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-limit, limit, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_leaf_count(tree):
    import jax

    return len(jax.tree_util.tree_leaves(tree))


@pytest.fixture()
def one_torch_thread():
    """Run the test's torch ops on one thread. Under the parallel test workers,
    torch's OpenMP threads oversubscribe the cores and spin at every barrier,
    which slows a whole-D0 float64 forward by orders of magnitude."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
