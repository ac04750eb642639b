"""Label, classes and anchors file loaders (the repo's text conventions).

The port's own copy of ``tmv_tpu/data/loaders.py::load_classes``,
``load_labels`` and ``load_anchors``: a classes txt with one name per line,
pipe-delimited label lines ``name.jpg|cls,x1,y1,x2,y2|…``, and the anchors csv
reshaped to ``(3, -1, 2)`` with the scale order reversed.
"""

import os
from typing import Dict, List, Tuple

import numpy as np


def load_classes(classes_path: str) -> Tuple[List[str], int]:
    with open(classes_path, "r", encoding="utf-8") as f:
        classes_name = [c.strip() for c in f.readlines()]
    return classes_name, len(classes_name)


def load_labels(labels_file: str, images_path: str,
                classes_name: List[str]) -> Tuple[List[Dict], int]:
    """Parse pipe-delimited labels; skips unknown classes and degenerate boxes
    like the reference (`load_object_detection_data.py:14-56`)."""
    labels = []
    with open(labels_file, "r", encoding="utf-8") as f:
        for line in f.readlines():
            parts = line.strip().split("|")
            classes, boxes = [], []
            for item in parts[1:]:
                if item == "":
                    continue
                info = item.split(",")
                if info[0] not in classes_name:
                    continue
                x1, y1, x2, y2 = (float(v) for v in info[1:5])
                if x2 <= x1 or y2 <= y1:
                    continue
                classes.append(classes_name.index(info[0]))
                boxes.append([x1, y1, x2, y2])
            labels.append({"image_path": os.path.join(images_path, parts[0]),
                           "classes": classes,
                           "boxes": np.array(boxes, np.float64).reshape([-1, 4])})
    return labels, len(labels)


def load_anchors(anchors_path: str) -> np.ndarray:
    """CSV anchors → (3, A, 2) int array, scale order reversed so index 0 is
    the coarsest (13²) scale."""
    with open(anchors_path, "r", encoding="utf-8") as f:
        anchors = [float(x) for x in f.readline().split(",")]
    anchors = np.array(anchors, dtype=np.int64).reshape(3, -1, 2)
    return anchors[[2, 1, 0]]
