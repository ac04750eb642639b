"""YOLO training data pipeline: sampler → host decode → device aug + targets.

Port of ``tmv_tpu/data/yolo_pipeline.py`` (the reference's ``DataGenerator``,
`datasets/coco_dataset.py:16-345`): class-balanced sampling, the random
aspect/scale/place/flip/HSV augmentation, grid targets, batching and prefetch.
The host only decodes images (PIL) and resizes them to the fixed staging size;
the augmentation and the targets run batched on the pipeline's device, and a
producer thread builds the next batches there while the caller trains.

The JAX package's ``_augment_one`` is split in two: ``draw_augment_params`` draws
each image's eleven numbers (two aspect factors, scale, dx, dy, the flip coin
and the five HSV draws) from a ``torch.Generator`` on the CPU, and
``augment_batch`` applies given numbers. The draws cannot equal threefry's; given
the same numbers, the geometry and the HSV shift are the JAX package's.

With ``image_random`` and ``mosaic`` > 0 the staged batch first goes through the
4-image mosaic (``data/mosaic.py``; its draws from the same generator, before
the augmentation's), as the JAX pipeline runs it. ``cache_dir`` serves the
staged frames from the memmap cache of ``data/stage_cache.py`` (tag
``yolo-stage-pil``): the first epoch decodes and fills it, later epochs read it.
The native JPEG decoder is not ported: staging decodes with PIL.

``rows`` (a data-parallel rank's rows of the global batch, ``parallel.mesh.
shard_rows``) makes the pipeline yield that rank's share: every rank samples the
global batch's labels and draws its random numbers, as the one-process pipeline does,
in the same order, and decodes only its rows (and, under the mosaic, the partner
frames its rows compose); the augmentation and the targets run on its rows.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from tmv_tpu_torch.data.image_ops import flip_boxes_lr, hsv_shift, load_image
from tmv_tpu_torch.data.loaders import load_classes, load_labels
from tmv_tpu_torch.data.mosaic import draw_mosaic_params, mosaic_batch
from tmv_tpu_torch.data.prefetch import prefetch_batches
from tmv_tpu_torch.data.samplers import ClassBalancedSampler
from tmv_tpu_torch.data.yolo_targets import make_yolo_targets, pad_labels
from tmv_tpu_torch.models.detector_harness import check_device

AUG_PARAMS = ("aspect_1", "aspect_2", "scale", "dx", "dy", "flip",
              "hue", "sat_up", "sat_coin", "val_up", "val_coin")


def draw_augment_params(gen: torch.Generator, n: int, jitter: float = 0.3, hue: float = 0.1,
                        sat: float = 1.5, val: float = 1.5) -> Dict[str, torch.Tensor]:
    """The eleven uniform draws of each of ``n`` images, ``(n,)`` float32 CPU
    tensors keyed by ``AUG_PARAMS``, in the ranges of the JAX package's draws."""
    bounds = torch.tensor([(1 - jitter, 1 + jitter), (1 - jitter, 1 + jitter), (0.25, 2.0),
                           (0.0, 1.0), (0.0, 1.0), (0.0, 1.0), (-hue, hue), (1.0, sat),
                           (0.0, 1.0), (1.0, val), (0.0, 1.0)], dtype=torch.float32)
    u = torch.rand((n, len(AUG_PARAMS)), generator=gen)
    values = u * (bounds[:, 1] - bounds[:, 0]) + bounds[:, 0]
    return {k: values[:, i] for i, k in enumerate(AUG_PARAMS)}


def augment_batch(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                  params: Dict[str, torch.Tensor], image_wh: Tuple[int, int], flip: bool = True):
    """Random aspect, scale (0.25..2), placement, flip and HSV of staged images.

    ``images`` ``(B, Hs, Ws, 3)`` uint8 content filling the staging frame,
    ``boxes`` ``(B, M, 4)`` xyxy in staging pixels, ``valid`` ``(B, M)``, and
    ``params`` the ``(B,)`` draws of ``draw_augment_params``. The content is
    resized to (nh, nw) into an (H, W) canvas at (dy, dx) by one inverse-affine
    bilinear gather. Returns ``(B, H, W, 3)`` float [0, 1] images, the moved and
    clipped boxes, and ``valid`` without boxes of 1 px or less.
    """
    w, h = image_wh
    dev = images.device
    p = {k: v.to(dev, torch.float32) for k, v in params.items()}
    batch, src_h, src_w = images.shape[0], images.shape[1], images.shape[2]

    def const(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    new_ar = (w / h) * (p["aspect_1"] / p["aspect_2"])
    scale = p["scale"]
    nh = torch.where(new_ar < 1, torch.floor(scale * h),
                     torch.floor(torch.floor(scale * w) / new_ar))
    nw = torch.where(new_ar < 1, torch.floor(nh * new_ar), torch.floor(scale * w))
    dx = torch.floor(p["dx"] * (w - nw))
    dy = torch.floor(p["dy"] * (h - nh))

    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    src_y = (ys - dy[:, None]) * (const(src_h) / nh)[:, None]                   # (B, H)
    src_x = (xs - dx[:, None]) * (const(src_w) / nw)[:, None]                   # (B, W)
    in_y = (src_y >= 0) & (src_y <= src_h - 1)
    in_x = (src_x >= 0) & (src_x <= src_w - 1)
    y0 = torch.clamp(torch.floor(src_y), 0, src_h - 1)
    x0 = torch.clamp(torch.floor(src_x), 0, src_w - 1)
    y1 = torch.clamp(y0 + 1, 0, src_h - 1)
    x1 = torch.clamp(x0 + 1, 0, src_w - 1)
    wy = (torch.clamp(src_y, 0, src_h - 1) - y0)[:, :, None, None]
    wx = (torch.clamp(src_x, 0, src_w - 1) - x0)[:, None, :, None]
    imgf = images.float()
    bi = torch.arange(batch, device=dev)[:, None, None]

    def at(yi, xi):
        return imgf[bi, yi.long()[:, :, None], xi.long()[:, None, :]]          # (B, H, W, 3)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    mask2d = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    out = torch.where(mask2d, out, torch.zeros_like(out))

    # boxes: from source pixels to canvas pixels
    sx, sy = nw / src_w, nh / src_h
    boxes = (boxes.float() * torch.stack([sx, sy, sx, sy], -1)[:, None, :]
             + torch.stack([dx, dy, dx, dy], -1)[:, None, :])
    limit = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    boxes = torch.minimum(torch.maximum(boxes, torch.zeros_like(boxes)), limit)

    do_flip = (p["flip"] < 0.5) & flip
    out = torch.where(do_flip[:, None, None, None], out.flip(2), out)
    boxes = torch.where(do_flip[:, None, None], flip_boxes_lr(boxes, float(w)), boxes)

    one = const(1.0)
    sat_scale = torch.where(p["sat_coin"] < 0.5, p["sat_up"], one / p["sat_up"])
    val_scale = torch.where(p["val_coin"] < 0.5, p["val_up"], one / p["val_up"])
    out = hsv_shift(out / 255.0, p["hue"], sat_scale, val_scale)

    boxes_wh = boxes[..., 2:4] - boxes[..., 0:2]
    valid = valid.bool() & (boxes_wh[..., 0] > 1) & (boxes_wh[..., 1] > 1)
    return out, boxes, valid


class YoloDataPipeline:
    """Endless iterator of batches on ``device``.

    Batch dict: ``image`` ``(B, H, W, 3)`` float [0, 1]; ``targets`` the tuple of
    per-scale ``(B, h, w, A, 5+C)`` grids ``models.detector_harness.make_yolo_loss_fn``
    consumes.
    """

    def __init__(self, image_path: str, label_path: str, classes_path: str, batch_size: int,
                 anchors: np.ndarray, image_wh: Tuple[int, int] = (416, 416),
                 label_mean: bool = True, image_random: bool = True, jitter: float = 0.3,
                 hue: float = 0.1, sat: float = 1.5, val: float = 1.5, flip: bool = True,
                 mosaic: float = 0.0, max_boxes: int = 100, seed: int = 0, prefetch: int = 2,
                 cache_dir: str = None, device="cuda", rows: Optional[Sequence[int]] = None):
        self.device = check_device(device)
        self.rows = None if rows is None else list(rows)
        self.classes, self.classes_num = load_classes(classes_path)
        self.labels, self.labels_num = load_labels(label_path, image_path, self.classes)
        self.batch_size = batch_size
        self.anchors_wh = np.asarray(anchors)
        self.image_wh = image_wh
        self.image_random = image_random
        self.aug = dict(jitter=jitter, hue=hue, sat=sat, val=val)
        self.flip = flip
        self.mosaic = mosaic
        self.max_boxes = max_boxes
        self.sampler = ClassBalancedSampler(self.labels, label_mean, seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.prefetch = prefetch
        self.cache = None
        if cache_dir:
            from tmv_tpu_torch.data.stage_cache import StageCache, assign_rows

            assign_rows(self.labels)
            self.cache = StageCache(cache_dir, self.labels, (image_wh[1], image_wh[0]),
                                    max_boxes, tag="yolo-stage-pil")

    def stage_one(self, label: Dict):
        """Host: one label's staged tuple, through the staging cache when there
        is one (``stage_one_uncached`` on a miss)."""
        if self.cache is not None:
            return self.cache.wrap(label, self.stage_one_uncached)
        return self.stage_one_uncached(label)

    def stage_one_uncached(self, label: Dict):
        """Host: decode and resize to exactly the staging size (boxes scaled
        alike) → (uint8 image, padded boxes, classes, valid)."""
        from PIL import Image

        w, h = self.image_wh
        img = load_image(label["image_path"])
        src_h, src_w = img.shape[0], img.shape[1]
        im = Image.fromarray(img).resize((w, h), Image.BILINEAR)
        boxes = np.asarray(label["boxes"], np.float32).reshape(-1, 4)
        boxes = boxes * np.asarray([w / src_w, h / src_h, w / src_w, h / src_h], np.float32)
        b, c, v = pad_labels(boxes, label["classes"], self.max_boxes)
        return np.asarray(im), b, c, v

    def stage_batch(self, labels, pool=None, decode=None):
        """Host: stage a batch, decodes fanned over ``pool``'s threads; with
        ``decode`` (row indices) only those rows, the others zero frames."""
        picked = labels if decode is None else [labels[i] for i in decode]
        staged = list(pool.map(self.stage_one, picked)) if pool else list(map(self.stage_one,
                                                                              picked))
        arrays = [np.stack(a) for a in zip(*staged)]
        if decode is None:
            return tuple(arrays)
        full = [np.zeros((len(labels),) + a.shape[1:], a.dtype) for a in arrays]
        for f, a in zip(full, arrays):
            f[decode] = a
        return tuple(full)

    def draw_mosaic(self, n: int):
        """The mosaic's draws of a batch of ``n`` (None without the mosaic)."""
        if not (self.image_random and self.mosaic > 0):
            return None
        return draw_mosaic_params(self.generator, n, self.image_wh, prob=self.mosaic)

    def rows_to_decode(self, mosaic_draws) -> Optional[list]:
        """This rank's rows and, under the mosaic, their gated partners (None: all)."""
        if self.rows is None:
            return None
        need = set(self.rows)
        if mosaic_draws is not None:
            partners, _, gate = mosaic_draws
            for r in self.rows:
                if bool(gate[r]):
                    need.update(int(p) for p in partners[:, r])
        return sorted(need)

    def device_batch(self, staged, mosaic_draws=None) -> Dict:
        """H2D of a staged batch, then augmentation and targets on the device (on
        ``rows`` of it where given). ``mosaic_draws`` are drawn here where not given."""
        imgs, boxes, classes, valid = (torch.from_numpy(a).to(self.device) for a in staged)
        if self.image_random and self.mosaic > 0:
            draws = mosaic_draws if mosaic_draws is not None else self.draw_mosaic(imgs.shape[0])
            imgs, boxes, classes, valid = mosaic_batch(imgs, boxes, classes, valid, *draws)
        params = (draw_augment_params(self.generator, imgs.shape[0], **self.aug)
                  if self.image_random else None)
        if self.rows is not None:
            take = torch.as_tensor(self.rows, device=imgs.device)
            imgs, boxes, classes, valid = (a[take] for a in (imgs, boxes, classes, valid))
            params = None if params is None else {k: v[self.rows] for k, v in params.items()}
        if self.image_random:
            images01, boxes, valid = augment_batch(imgs, boxes, valid, params, self.image_wh,
                                                   self.flip)
        else:
            images01 = imgs.float() / 255.0
        targets = make_yolo_targets(boxes, classes, valid, self.anchors_wh, self.image_wh,
                                    self.classes_num)
        return {"image": images01, "targets": targets}

    def __iter__(self) -> Iterator[Dict]:
        """Batches forever. With ``prefetch`` > 0 one producer thread stages and
        builds the next batches (host decode, H2D, augmentation, targets) while
        the caller consumes; one producer keeps the draws in the order of the
        ``prefetch=0`` path. Closing the iterator stops the thread."""
        it = iter(self.sampler)
        pool = ThreadPoolExecutor(min(8, self.batch_size)) if self.batch_size > 1 else None

        def next_batch():
            labels = [next(it) for _ in range(self.batch_size)]
            draws = self.draw_mosaic(len(labels))
            staged = self.stage_batch(labels, pool, self.rows_to_decode(draws))
            return self.device_batch(staged, draws)

        try:
            yield from prefetch_batches(next_batch, self.prefetch)
        finally:
            if pool is not None:
                pool.shutdown()
