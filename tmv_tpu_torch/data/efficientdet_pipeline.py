"""EfficientDet training data pipeline: sampler → host staging → device targets.

Port of ``tmv_tpu/data/efficientdet_pipeline.py`` (the reference's
``coco_dataset_one.py``): pipe-delimited label files whose class ids are shifted
by +1 (0 is background), boxes in yxyx, boxes under 2 px dropped, class-balanced
sampling, a producer thread with a bounded queue. Two paths:

- **host augmentation** (default): each image is decoded, blurred (PIL radius
  0-4), warped (scale 0.5-2, offset ±45 px), salted with noise and letterboxed
  on the host, its numbers drawn from Python's ``random`` and a numpy
  ``Generator`` seeded per item from the pipeline's seed, so a seed gives the
  JAX pipeline's images, boxes and classes exactly;
- **device augmentation** (``device_aug``, the ``--deviceAug`` flag): the host
  only decodes and letterboxes to uint8; blur, warp and noise run batched on the
  device (``data/device_aug.py``) from a ``torch.Generator`` there (other draws
  than JAX's threefry keys; the same distribution).

Either way the batch's anchor targets are made on the device by one batched
``Anchors.generate_targets``, the host arrays copied from pinned memory.
``with_raw_boxes`` adds each image's yxyx boxes and classes for the eval.
``cache_dir`` (device augmentation only: the host path draws anew every epoch)
serves the letterboxed uint8 frames from the memmap cache of
``data/stage_cache.py`` (tag ``efficientdet-stage-pil``). The native JPEG
decoder is not ported: staging decodes with PIL.

``rows`` (a data-parallel rank's rows of the global batch, ``parallel.mesh.
shard_rows``) makes the pipeline yield that rank's share: every rank samples the
global batch's labels, per-item seeds and device draws in the one-process order,
decodes only its rows, and augments and assigns targets on its rows.
"""

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from tmv_tpu_torch.data.device_aug import augment_batch, draw_params
from tmv_tpu_torch.data.loaders import load_classes, load_labels
from tmv_tpu_torch.data.prefetch import prefetch_batches
from tmv_tpu_torch.data.samplers import ClassBalancedSampler
from tmv_tpu_torch.data.yolo_targets import pad_labels
from tmv_tpu_torch.models.detector_harness import check_device
from tmv_tpu_torch.ops.anchors import Anchors
from tmv_tpu_torch.utils import image_helper


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """H2D of a host array, from pinned memory where the device is a GPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class EfficientDetPipeline:
    """Endless iterator of batches on ``device``.

    Batch dict: ``image`` ``(B, S, S, 3)`` float32 [0, 1]; ``boxes``, ``classes``
    and ``masks`` the per-level targets of ``Anchors.generate_targets``; with
    ``with_raw_boxes``, ``raw``: per image (yxyx boxes, classes) host arrays.
    """

    def __init__(self, image_path: str, label_path: str, classes_path: str, batch_size: int,
                 anchors: Anchors, num_classes: int, image_size: int = 512,
                 max_boxes: int = 100, augment: bool = True, label_mean: bool = True,
                 seed: int = 0, with_raw_boxes: bool = False, device_aug: bool = False,
                 prefetch: int = 2, cache_dir: str = None, device="cuda",
                 rows: Optional[Sequence[int]] = None):
        self.device = check_device(device)
        self.rows = None if rows is None else list(rows)
        self.classes, _ = load_classes(classes_path)
        self.labels, self.labels_num = load_labels(label_path, image_path, self.classes)
        self.batch_size = batch_size
        self.anchors = anchors
        self.num_classes = num_classes
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.augment = augment
        self.with_raw_boxes = with_raw_boxes
        self.device_aug = device_aug and augment
        self.prefetch = prefetch
        self.sampler = ClassBalancedSampler(self.labels, label_mean, seed)
        self._rng = random.Random(seed)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.cache = None
        if cache_dir:
            if not self.device_aug:
                raise ValueError("cache_dir requires device_aug=True: only the fixed staging "
                                 "frame is deterministic; the host-aug path draws anew every "
                                 "epoch and is not cacheable")
            from tmv_tpu_torch.data.stage_cache import StageCache, assign_rows

            assign_rows(self.labels)
            self.cache = StageCache(cache_dir, self.labels, (image_size, image_size), max_boxes,
                                    tag="efficientdet-stage-pil")

    # ---------------------------------------------------------------- host
    def get_random_data(self, label: Dict, seed: int):
        """Host path of one image, its draws from RNGs seeded by ``seed`` →
        (float32 [0, 1] letterboxed image, yxyx boxes, classes + 1)."""
        rng = random.Random(seed)
        np_rng = np.random.default_rng(seed)
        with open(label["image_path"], "rb") as f:
            img = image_helper.bytes_to_image(f.read())
        boxes = np.asarray(label["boxes"], np.float64).reshape(-1, 4)  # xyxy
        if self.augment:
            from PIL import Image

            ksize = rng.randint(0, 4)
            if ksize > 0:
                img = image_helper.blur(img, ksize)
            # affine scale + offset (angles disabled in the reference)
            sx = rng.random() * 1.5 + 0.5
            sy = rng.random() * 1.5 + 0.5
            dx = rng.random() * 90 - 45
            dy = rng.random() * 90 - 45
            h, w = img.shape[:2]
            # inverse affine for PIL: out(x, y) = in(a x + b y + c, …)
            coeffs = (1 / sx, 0, -(dx + w / 2 * (1 - sx)) / sx,
                      0, 1 / sy, -(dy + h / 2 * (1 - sy)) / sy)
            img = np.asarray(Image.fromarray(img).transform((w, h), Image.AFFINE, coeffs,
                                                            Image.BILINEAR))
            pts = boxes.reshape(-1, 2)
            pts = pts * [sx, sy] + [dx + w / 2 * (1 - sx), dy + h / 2 * (1 - sy)]
            boxes = pts.reshape(-1, 4)
            img = image_helper.random_noise(img, np_rng)
        img, pts, _ = image_helper.proportional_resize(
            img, (self.image_size, self.image_size), points=boxes.reshape(-1, 2))
        boxes = np.clip(pts.reshape(-1, 4), 0, self.image_size)
        mask = (boxes[:, 2] - boxes[:, 0] >= 2) & (boxes[:, 3] - boxes[:, 1] >= 2)
        boxes = boxes[mask][:, [1, 0, 3, 2]]  # xyxy → yxyx
        classes = np.asarray(label["classes"], np.int32)[mask] + 1   # background is 0
        return img.astype(np.float32) / 255.0, boxes, classes

    def stage_fixed(self, label: Dict):
        """Host staging of the device-augmentation path, through the staging
        cache when there is one (``stage_fixed_uncached`` on a miss)."""
        if self.cache is not None:
            return self.cache.wrap(label, self.stage_fixed_uncached)
        return self.stage_fixed_uncached(label)

    def stage_fixed_uncached(self, label: Dict):
        """Decode and letterbox to the network frame only → (uint8 image, padded
        xyxy boxes, classes + 1, valid)."""
        s = self.image_size
        boxes = np.asarray(label["boxes"], np.float32).reshape(-1, 4)  # xyxy
        with open(label["image_path"], "rb") as f:
            img = image_helper.bytes_to_image(f.read())
        img_u8, pts, _ = image_helper.proportional_resize(img, (s, s),
                                                          points=boxes.reshape(-1, 2))
        boxes = np.asarray(pts, np.float32).reshape(-1, 4)
        return (img_u8,) + pad_labels(boxes, [c + 1 for c in label["classes"]], self.max_boxes)

    # -------------------------------------------------------------- device
    def targets(self, boxes_yxyx: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor):
        return self.anchors.generate_targets(boxes_yxyx, classes, self.num_classes, valid)

    def host_aug_batch(self, items, pool=None) -> Dict:
        """One batch of the host path from ``(label, seed)`` items."""
        staged = (list(pool.map(lambda a: self.get_random_data(*a), items)) if pool
                  else [self.get_random_data(*a) for a in items])
        padded = [pad_labels(boxes, classes.tolist(), self.max_boxes)
                  for _, boxes, classes in staged]
        boxes, classes, valid = (to_device(np.stack(z), self.device) for z in zip(*padded))
        boxes_t, classes_t, masks_t = self.targets(boxes, classes, valid)
        batch = {"image": to_device(np.stack([img for img, _, _ in staged]), self.device),
                 "boxes": boxes_t, "classes": classes_t, "masks": masks_t}
        if self.with_raw_boxes:
            batch["raw"] = [(boxes, classes) for _, boxes, classes in staged]
        return batch

    def stage_batch(self, labels, pool=None):
        """Host half of the device path: the batch's ``stage_fixed`` arrays,
        stacked, decodes fanned over ``pool``'s threads."""
        staged = list(pool.map(self.stage_fixed, labels)) if pool else map(self.stage_fixed,
                                                                           labels)
        return tuple(np.stack(z) for z in zip(*staged))

    def device_batch(self, staged, params=None) -> Dict:
        """Device half: H2D of a staged batch, then the augmentation (``params``:
        given draws, else drawn from ``self.generator``) and the targets."""
        imgs, boxes, classes, valid = (to_device(a, self.device) for a in staged)
        if params is None:
            if self.rows is None:
                params = draw_params(self.generator, imgs.shape[0], self.image_size)
            else:      # the global batch's draws, this rank's rows
                params = draw_params(self.generator, self.batch_size, self.image_size)
                params = {k: v[self.rows] for k, v in params.items()}
        images01, boxes, valid = augment_batch(imgs, boxes, valid, params, self.image_size)
        boxes_t, classes_t, masks_t = self.targets(boxes[..., [1, 0, 3, 2]], classes, valid)
        return {"image": images01, "boxes": boxes_t, "classes": classes_t, "masks": masks_t}

    def __iter__(self) -> Iterator[Dict]:
        """Batches forever, ``prefetch`` ahead on a producer thread (0: in the
        caller's thread); closing the iterator stops the thread."""
        it = iter(self.sampler)
        pool = ThreadPoolExecutor(min(8, self.batch_size)) if self.batch_size > 1 else None

        def mine(batch):
            return batch if self.rows is None else [batch[i] for i in self.rows]

        def next_batch():
            if self.device_aug:
                labels = [next(it) for _ in range(self.batch_size)]
                return self.device_batch(self.stage_batch(mine(labels), pool))
            items = [(next(it), self._rng.getrandbits(32)) for _ in range(self.batch_size)]
            return self.host_aug_batch(mine(items), pool)

        try:
            yield from prefetch_batches(next_batch, self.prefetch)
        finally:
            if pool is not None:
                pool.shutdown()
