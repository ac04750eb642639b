"""Image augmentation ops of the YOLO training pipeline, in torch.

Port of ``tmv_tpu/data/image_ops.py::load_image``, ``flip_boxes_lr``,
``hsv_shift``, ``rgb_to_hsv`` and ``hsv_to_rgb`` (`coco_dataset.py:147-174`),
in the JAX package's operation order. The ops take a leading batch axis.
``hsv_shift`` takes its three factors as arguments where the JAX function
draws them from a key: the draws are made by
``data.yolo_pipeline.draw_augment_params``, so a caller can inject any draws.
"""

import numpy as np
import torch


def load_image(path: str) -> np.ndarray:
    """Host image decode → uint8 RGB (PIL)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def flip_boxes_lr(boxes: torch.Tensor, width: float) -> torch.Tensor:
    """Mirror xyxy boxes horizontally."""
    return torch.cat([width - boxes[..., 2:3], boxes[..., 1:2],
                      width - boxes[..., 0:1], boxes[..., 3:4]], dim=-1)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB→HSV on [0, 1] floats (tf.image.rgb_to_hsv semantics)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    rangec = maxc - minc
    safe_range = torch.where(rangec == 0, 1.0, rangec)
    s = torch.where(maxc == 0, 0.0, rangec / torch.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe_range
    gc = (maxc - g) / safe_range
    bc = (maxc - b) / safe_range
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rangec == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6).long()[..., None]

    def choose(*options):
        return torch.gather(torch.stack(options, dim=-1), -1, i)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def hsv_shift(img01: torch.Tensor, hue_shift: torch.Tensor, sat_scale: torch.Tensor,
              val_scale: torch.Tensor) -> torch.Tensor:
    """HSV distortion of ``(..., H, W, 3)`` images by per-image factors of shape
    ``(...)``: hue shifted with wrap-around, saturation and value scaled,
    clipped to [0, 1]."""
    hsv = rgb_to_hsv(img01)
    shape = hue_shift.shape + (1, 1, 1)
    h = hsv[..., 0:1] + hue_shift.reshape(shape)
    h = torch.where(h > 1.0, h - 1.0, h)
    h = torch.where(h < 0.0, h + 1.0, h)
    s = hsv[..., 1:2] * sat_scale.reshape(shape)
    v = hsv[..., 2:3] * val_scale.reshape(shape)
    return hsv_to_rgb(torch.clamp(torch.cat([h, s, v], dim=-1), 0.0, 1.0))
