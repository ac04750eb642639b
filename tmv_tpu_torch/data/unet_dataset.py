"""UNet keypoint dataset: labelme JSON 4-corner labels + host augmentation.

Port of ``tmv_tpu/data/unet_dataset.py`` (the reference's
`unet/dataset_ywb.py:17-173`): scan ``*.json`` labelme files (exactly one shape
of 4 corner points, or the first shape with ``first_shape``), order the corners
by centroid quadrant (LT, LB, RT, RB), and per sample a random perspective
(angles ±30/±30/±20°), a shift of ±45 px, blur, noise and colour jitter, a
proportional letterbox resize, and points normalized to [0, 1] in (y, x)
order; samples whose points leave the frame are skipped. The draws come from
``random.Random(seed)`` and ``np.random.default_rng(seed)`` on the host, as the
JAX module's, so a seed gives its images exactly. Targets are Gaussian heatmaps
made on the host by ``ops.soft_label.SoftLabel``.
"""

import json
import os
import random
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from tmv_tpu_torch.ops.soft_label import SoftLabel
from tmv_tpu_torch.utils import image_helper
from tmv_tpu_torch.utils.file_helper import read_file_list


def order_corners(points: np.ndarray) -> np.ndarray | None:
    """Order 4 points as (LT, LB, RT, RB) by centroid quadrant
    (`dataset_ywb.py:87-103`); None if any quadrant is empty."""
    cx = (points[:, 0].min() + points[:, 0].max()) / 2
    cy = (points[:, 1].min() + points[:, 1].max()) / 2
    lt = lb = rt = rb = None
    for p in points:
        if p[0] < cx and p[1] < cy:
            lt = p
        elif p[0] > cx and p[1] < cy:
            rt = p
        elif p[0] < cx and p[1] > cy:
            lb = p
        elif p[0] > cx and p[1] > cy:
            rb = p
    if any(v is None for v in (lt, lb, rt, rb)):
        return None
    return np.float32([lt, lb, rt, rb])


def load_labelme_labels(label_path: str, first_shape: bool = False) -> List[Dict]:
    """``first_shape=False`` keeps the reference's exactly-one-shape filter
    (`dataset_ywb.py:84-85`); True takes the first shape of multi-shape
    files instead — the reference's own shipped `train_data/json` files all
    have multiple shapes and would otherwise load zero labels."""
    labels = []
    for file_path in read_file_list(label_path, r"\.json$"):
        with open(file_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        n_shapes = len(data.get("shapes", []))
        if n_shapes == 0 or (n_shapes != 1 and not first_shape):
            continue
        json_dir = os.path.dirname(file_path)
        image_path = os.path.join(
            json_dir, data["imagePath"].replace("\\", "/"))
        points = order_corners(np.float32(data["shapes"][0]["points"]))
        if points is None:
            continue
        labels.append({"image_path": image_path, "points": points})
    return labels


class UNetDataGenerator:
    def __init__(self, label_path: str, input_shape: Tuple[int, int],
                 seed: int | None = None, augment: bool = True,
                 first_shape: bool = False):
        self.input_shape = input_shape  # (W, H) like the reference
        self.labels = load_labelme_labels(label_path, first_shape)
        self.labels_num = len(self.labels)
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self.augment = augment

    def _get_random_data(self, image: np.ndarray, points: np.ndarray):
        r = self._rng.random
        degrees = (r() * 60 - 30, r() * 60 - 30, r() * 40 - 20)
        image, points = image_helper.perspective(
            image, points=points, degrees=degrees)
        # offsets: shift both image and points
        dx, dy = r() * 90 - 45, r() * 90 - 45
        shifted = np.zeros_like(image)
        h, w = image.shape[:2]
        sx, sy = int(round(dx)), int(round(dy))
        src_x = slice(max(0, -sx), min(w, w - sx))
        dst_x = slice(max(0, sx), min(w, w + sx))
        src_y = slice(max(0, -sy), min(h, h - sy))
        dst_y = slice(max(0, sy), min(h, h + sy))
        shifted[dst_y, dst_x] = image[src_y, src_x]
        image = shifted
        points = points + [sx, sy]
        ksize = self._rng.randint(0, 4)
        if ksize > 0:
            image = image_helper.blur(image, ksize)
        image = image_helper.random_noise(image, self._np_rng)
        image = image_helper.random_color_jitter(image, self._np_rng)
        return image, points

    def generate(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.labels)
        i = 0
        clone = self.labels.copy()
        while True:
            if i == 0:
                self._rng.shuffle(clone)
            label = clone[i]
            i = (i + 1) % n
            with open(label["image_path"], "rb") as f:
                img = image_helper.bytes_to_image(f.read())
            points = label["points"].copy()
            if self.augment:
                img, points = self._get_random_data(img, points)
            img, points, _ = image_helper.proportional_resize(
                img, self.input_shape, points=points)
            img01 = img.astype(np.float32) / 255.0
            points = points / np.asarray(self.input_shape, np.float32)
            points = points[..., ::-1]  # (x, y) → (y, x)
            if (points < 0).any() or (points > 1).any():
                continue
            yield img01, points.astype(np.float32)


def get_dataset(label_path: str, batch_size: int, points_num: int,
                input_size: Tuple[int, int], output_size: Tuple[int, int],
                kernel_size: Tuple[int, int] = (11, 11), seed: int = 0,
                augment: bool = True, first_shape: bool = False):
    """Endless iterator of ``{"image", "target"}`` CPU float32 batches
    (``(B, H, W, 3)`` in [0, 1], ``(B, h, w, points_num)`` heatmaps), and the
    generator (`dataset_ywb.py:150-173`)."""
    gen = UNetDataGenerator(label_path, input_size, seed, augment, first_shape)
    if gen.labels_num == 0:
        raise ValueError(
            f"no usable labelme files under {label_path!r}: the default keeps the "
            "reference's exactly-one-shape filter (dataset_ywb.py:84-85); multi-shape "
            "files need first_shape=True (CLI: --firstShape)")
    soft_label = SoftLabel(image_size=output_size, points_num=points_num,
                           kernel_size=kernel_size)

    def batches():
        it = gen.generate()
        while True:
            imgs, targets = [], []
            for _ in range(batch_size):
                img, points = next(it)
                imgs.append(img)
                pts = torch.from_numpy((points * np.asarray(output_size)).astype(np.int32))
                targets.append(soft_label.get_target(pts))
            yield {"image": torch.from_numpy(np.stack(imgs)), "target": torch.stack(targets)}

    return batches(), gen
