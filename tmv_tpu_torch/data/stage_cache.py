"""Decoded-image staging cache (uint8 memmaps, persistent across epochs).

The port's own copy of ``tmv_tpu/data/stage_cache.py``. Staging (decode and
resize or letterbox to the fixed staging frame) is deterministic per (image,
frame size, label row): every random augmentation runs on the device after it.
So the first epoch writes each staged frame and its padded labels into flat
memmaps, and every later epoch reads them back instead of decoding again.

Layout under ``directory``::

    meta.json    fingerprint + shapes (guards stale caches)
    images.u8    (n, h, w, 3) uint8
    boxes.f32    (n, max_boxes, 4) float32   staged-frame pixel coords
    classes.i32  (n, max_boxes) int32
    valid.u8     (n, max_boxes) uint8 (bool)
    filled.u8    (n,) uint8 — row i valid iff filled[i] == 1

Safe under the staging thread pools: each label owns one row written by one
worker, ``filled`` is set last, and reads trust only filled rows. A fingerprint
mismatch (another label file, image sizes, frame, ``max_boxes`` or decode
``tag``) rebuilds the cache.
"""

import hashlib
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_VERSION = 1


def _fingerprint(labels: Sequence[Dict], frame_hw: Tuple[int, int],
                 max_boxes: int, tag: str) -> str:
    h = hashlib.sha1()
    head = {
        "version": _VERSION,
        "tag": tag,
        "frame_hw": list(frame_hw),
        "max_boxes": max_boxes,
        "n": len(labels),
    }
    h.update(json.dumps(head, sort_keys=True).encode())
    for lb in labels:
        path = lb["image_path"]
        try:
            size = os.path.getsize(path)
        except OSError:
            size = -1
        item = (path, size, [float(x) for x in np.ravel(lb["boxes"])],
                [int(c) for c in lb["classes"]])
        h.update(repr(item).encode())
    return h.hexdigest()


class StageCache:
    """Memmap cache of staged (image_u8, boxes, classes, valid) rows."""

    def __init__(self, directory: str, labels: Sequence[Dict],
                 frame_hw: Tuple[int, int], max_boxes: int, tag: str = ""):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.n = len(labels)
        self.frame_hw = (int(frame_hw[0]), int(frame_hw[1]))
        self.max_boxes = int(max_boxes)
        fp = _fingerprint(labels, self.frame_hw, self.max_boxes, tag)
        meta_path = os.path.join(self.directory, "meta.json")
        fresh = True
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    fresh = json.load(f).get("fingerprint") != fp
            except (OSError, ValueError):
                fresh = True
        mode = "w+" if fresh else "r+"
        h, w = self.frame_hw
        self._images = np.memmap(
            os.path.join(self.directory, "images.u8"), np.uint8, mode,
            shape=(self.n, h, w, 3))
        self._boxes = np.memmap(
            os.path.join(self.directory, "boxes.f32"), np.float32, mode,
            shape=(self.n, self.max_boxes, 4))
        self._classes = np.memmap(
            os.path.join(self.directory, "classes.i32"), np.int32, mode,
            shape=(self.n, self.max_boxes))
        self._valid = np.memmap(
            os.path.join(self.directory, "valid.u8"), np.uint8, mode,
            shape=(self.n, self.max_boxes))
        self._filled = np.memmap(
            os.path.join(self.directory, "filled.u8"), np.uint8, mode,
            shape=(self.n,))
        if fresh:
            self._filled[:] = 0
            with open(meta_path, "w") as f:
                json.dump({"fingerprint": fp, "n": self.n,
                           "frame_hw": list(self.frame_hw),
                           "max_boxes": self.max_boxes, "tag": tag,
                           "version": _VERSION}, f)

    def __len__(self) -> int:
        return self.n

    @property
    def filled_count(self) -> int:
        return int(np.count_nonzero(self._filled))

    def get(self, row: int) -> Optional[Tuple[np.ndarray, ...]]:
        """Staged tuple for ``row``, or None if not cached yet.  Views
        into the memmaps (zero-copy; batch assembly's ``np.stack``
        copies)."""
        if not self._filled[row]:
            return None
        return (self._images[row], self._boxes[row], self._classes[row],
                self._valid[row].astype(bool))

    def put(self, row: int, img_u8: np.ndarray, boxes: np.ndarray,
            classes: np.ndarray, valid: np.ndarray) -> None:
        self._images[row] = img_u8
        self._boxes[row] = boxes
        self._classes[row] = classes
        self._valid[row] = valid.astype(np.uint8)
        self._filled[row] = 1  # publish last

    def wrap(self, label: Dict, stage_fn):
        """Serve ``label`` from the cache, staging + filling on miss.
        ``label['_cache_row']`` must have been assigned (see
        ``assign_rows``)."""
        row = label["_cache_row"]
        hit = self.get(row)
        if hit is not None:
            return hit
        out = stage_fn(label)
        self.put(row, *out)
        return out


def assign_rows(labels: Sequence[Dict]) -> None:
    """Tag each label dict with its cache row (the sampler re-yields the
    same dict objects, so the tag rides along)."""
    for i, lb in enumerate(labels):
        lb["_cache_row"] = i
