"""K-means anchor clustering for custom datasets.

The port's own copy of ``tmv_tpu/utils/kmeans_anchors.py`` (numpy only).

Capability parity with `AIServer/ai_api/ai_models/utils/kmeans_xray.py:13-80`
(VOC-XML 9-anchor k-means): IoU-distance k-means over box (w, h), from
either VOC XML dirs or the repo's pipe-delimited label files.  Output order
matches the anchors-csv convention consumed by ``data.loaders.load_anchors``
(ascending area; that loader reverses scale order itself).
"""

import glob
import os
import xml.etree.ElementTree as ET
from typing import List, Tuple

import numpy as np


def iou_wh(boxes: np.ndarray, clusters: np.ndarray) -> np.ndarray:
    """IoU of (N, 2) whs against (K, 2) cluster whs, centered at origin."""
    inter = np.minimum(boxes[:, None, 0], clusters[None, :, 0]) * np.minimum(
        boxes[:, None, 1], clusters[None, :, 1]
    )
    area_b = boxes[:, 0] * boxes[:, 1]
    area_c = clusters[:, 0] * clusters[:, 1]
    return inter / (area_b[:, None] + area_c[None, :] - inter)


def kmeans_wh(boxes: np.ndarray, k: int = 9, seed: int = 0,
              iters: int = 1000) -> np.ndarray:
    """IoU-distance k-means; returns (k, 2) whs sorted by area."""
    rng = np.random.default_rng(seed)
    clusters = boxes[rng.choice(len(boxes), k, replace=False)].astype(np.float64)
    last = None
    for _ in range(iters):
        assign = np.argmax(iou_wh(boxes, clusters), axis=1)
        if last is not None and (assign == last).all():
            break
        for ci in range(k):
            members = boxes[assign == ci]
            if len(members):
                clusters[ci] = np.median(members, axis=0)
        last = assign
    order = np.argsort(clusters[:, 0] * clusters[:, 1])
    return clusters[order]


def boxes_from_voc_xml(xml_dir: str) -> np.ndarray:
    whs: List[Tuple[float, float]] = []
    for path in glob.glob(os.path.join(xml_dir, "*.xml")):
        root = ET.parse(path).getroot()
        for obj in root.iter("object"):
            box = obj.find("bndbox")
            w = float(box.find("xmax").text) - float(box.find("xmin").text)
            h = float(box.find("ymax").text) - float(box.find("ymin").text)
            if w > 0 and h > 0:
                whs.append((w, h))
    return np.asarray(whs, np.float64)


def boxes_from_labels_file(labels_file: str) -> np.ndarray:
    whs: List[Tuple[float, float]] = []
    with open(labels_file, "r", encoding="utf-8") as f:
        for line in f:
            for item in line.strip().split("|")[1:]:
                if not item:
                    continue
                parts = item.split(",")
                x1, y1, x2, y2 = (float(v) for v in parts[1:5])
                if x2 > x1 and y2 > y1:
                    whs.append((x2 - x1, y2 - y1))
    return np.asarray(whs, np.float64)


def save_anchors_csv(anchors: np.ndarray, path: str):
    flat = anchors.astype(np.int64).reshape(-1)
    with open(path, "w", encoding="utf-8") as f:
        f.write(",".join(str(int(v)) for v in flat))
