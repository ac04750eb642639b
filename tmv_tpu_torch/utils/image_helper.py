"""Host-side image helpers of serving and the EfficientDet pipeline (PIL, numpy).

The port's own copy of part of ``tmv_tpu/utils/image_helper.py``: base64/bytes/
array conversions, the proportional letterbox resize, box drawing, and the
host augmentation's ``blur`` and ``random_noise``. Images are numpy RGB uint8
``(H, W, 3)``.
"""

import base64
import io
from typing import Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFilter


# ----------------------------------------------------------------- conversions
def base64_to_bytes(b64: str) -> bytes:
    return base64.b64decode(b64)


def bytes_to_base64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def bytes_to_image(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def image_to_bytes(img: np.ndarray, format: str = "JPEG") -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(buf, format=format)
    return buf.getvalue()


def get_image_size(img: np.ndarray) -> Tuple[int, int]:
    """(width, height), the reference's ``opencvGetImageSize`` order."""
    return img.shape[1], img.shape[0]


# ----------------------------------------------------------- letterbox resize
def proportional_resize(
    img: np.ndarray,
    target_size: Sequence[int],
    points: np.ndarray | None = None,
    bg_color: Tuple[int, int, int] = (0, 0, 0),
):
    """Proportional resize with centered padding + point transform.

    Args:
        target_size: (W, H).
        points: optional (N, 2) xy points to transform along.

    Returns:
        (resized_img, transformed_points, padding) where padding is
        (top, bottom, left, right) in target pixels.
    """
    h, w = img.shape[0], img.shape[1]
    tw, th = int(target_size[0]), int(target_size[1])
    ratio = max(w / tw, h / th)
    nw = int(w / ratio)
    nh = int(h / ratio)
    pad_left = (tw - nw) // 2
    pad_top = (th - nh) // 2
    pad_right = tw - nw - pad_left
    pad_bottom = th - nh - pad_top
    resized = np.asarray(
        Image.fromarray(np.asarray(img, np.uint8)).resize((nw, nh),
                                                          Image.BILINEAR)
    )
    out = np.empty((th, tw, 3), np.uint8)
    out[...] = np.asarray(bg_color, np.uint8)
    out[pad_top : pad_top + nh, pad_left : pad_left + nw] = resized
    new_points = None
    if points is not None:
        pts = np.asarray(points, np.float64)
        new_points = pts / ratio + np.asarray([pad_left, pad_top])
    return out, new_points, (pad_top, pad_bottom, pad_left, pad_right)


# ----------------------------------------------------------------- augmentation
def random_noise(img: np.ndarray, rng: np.random.Generator, amount: float = 0.02) -> np.ndarray:
    """Salt-and-pepper style noise: ``amount`` of the pixels get a random RGB."""
    out = img.copy()
    mask = rng.uniform(size=img.shape[:2]) < amount
    out[mask] = rng.integers(0, 256, size=(mask.sum(), 3), dtype=np.uint8)
    return out


def blur(img: np.ndarray, radius: float = 1.5) -> np.ndarray:
    """PIL Gaussian blur of ``radius``."""
    return np.asarray(
        Image.fromarray(np.asarray(img, np.uint8)).filter(ImageFilter.GaussianBlur(radius)))


# --------------------------------------------------------------------- drawing
def draw_boxes(img: np.ndarray, boxes: np.ndarray, labels: Sequence[str],
               scores: Sequence[float] | None = None) -> np.ndarray:
    """Rectangle + class-name + score drawing like the reference's serving view."""
    im = Image.fromarray(np.asarray(img, np.uint8))
    draw = ImageDraw.Draw(im)
    for i, box in enumerate(np.asarray(boxes, np.int64)):
        x1, y1, x2, y2 = box[:4].tolist()
        draw.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=1)
        if i < len(labels):
            draw.text((x1, max(0, y1 - 10)), str(labels[i]), fill=(0, 100, 0))
        if scores is not None and i < len(scores):
            draw.text((x1, y1 + 10), f"{scores[i]:.3f}", fill=(100, 0, 0))
    return np.asarray(im)
