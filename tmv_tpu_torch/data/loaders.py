"""Classes and anchors file loaders (the repo's text conventions).

The port's own copy of ``tmv_tpu/data/loaders.py::load_classes`` and
``load_anchors``: a classes txt with one name per line, and the anchors csv
reshaped to ``(3, -1, 2)`` with the scale order reversed.
"""

from typing import List, Tuple

import numpy as np


def load_classes(classes_path: str) -> Tuple[List[str], int]:
    with open(classes_path, "r", encoding="utf-8") as f:
        classes_name = [c.strip() for c in f.readlines()]
    return classes_name, len(classes_name)


def load_anchors(anchors_path: str) -> np.ndarray:
    """CSV anchors → (3, A, 2) int array, scale order reversed so index 0 is
    the coarsest (13²) scale."""
    with open(anchors_path, "r", encoding="utf-8") as f:
        anchors = [float(x) for x in f.readline().split(",")]
    anchors = np.array(anchors, dtype=np.int64).reshape(3, -1, 2)
    return anchors[[2, 1, 0]]
