"""Host-side image helpers of serving, the detect CLI and the pipelines (PIL, numpy).

The port's own copy of ``tmv_tpu/utils/image_helper.py``: base64/bytes/array/file
conversions, the proportional letterbox resize, the perspective warp with point
tracking, the host augmentations (``random_noise``, ``random_color_jitter``,
``random_lines``, ``blur``), ``crop`` and box drawing. Images are numpy RGB
uint8 ``(H, W, 3)``.
"""

import base64
import io
import math
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


def image_to_file(path: str, img: np.ndarray):
    Image.fromarray(np.asarray(img).astype(np.uint8)).save(path)


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


# ------------------------------------------------------------------ transforms
def perspective(
    img: np.ndarray,
    points: np.ndarray | None = None,
    degrees: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    bg_color: Tuple[int, int, int] = (0, 0, 0),
):
    """3-D-ish perspective/rotation warp with point tracking.

    Capability match for ``opencvPerspective`` (`image_helper.py:110-199`):
    rotate the image plane by (rx, ry, rz) degrees about its center and
    project back, keeping tracked points aligned.  Implemented as an exact
    3×3 homography on the four corners + PIL inverse-coefficient warp.
    """
    h, w = img.shape[0], img.shape[1]
    rx, ry, rz = (math.radians(d) for d in degrees)
    f = max(h, w)  # focal length ~ image size

    def rot_matrix():
        cx, sx = math.cos(rx), math.sin(rx)
        cy, sy = math.cos(ry), math.sin(ry)
        cz, sz = math.cos(rz), math.sin(rz)
        mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return mz @ my @ mx

    r = rot_matrix()

    def project(pts):
        p = np.asarray(pts, np.float64) - [w / 2, h / 2]
        p3 = np.concatenate([p, np.zeros((len(p), 1))], axis=1) @ r.T
        z = p3[:, 2] + f
        return (p3[:, 0:2] * (f / z)[:, None]) + [w / 2, h / 2]

    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    dst = project(src)

    # solve homography dst→src for PIL (which wants inverse coefficients)
    def solve_h(src_pts, dst_pts):
        a, b = [], []
        for (x, y), (u, v) in zip(dst_pts, src_pts):
            a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
            a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
            b.extend([u, v])
        return np.linalg.solve(np.asarray(a), np.asarray(b))

    coeffs = solve_h(src, dst)
    warped = Image.fromarray(np.asarray(img, np.uint8)).transform(
        (w, h), Image.PERSPECTIVE, coeffs, Image.BILINEAR,
        fillcolor=tuple(bg_color),
    )
    new_points = project(points) if points is not None else None
    return np.asarray(warped), new_points


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


def random_color_jitter(img: np.ndarray, rng: np.random.Generator,
                        strength: float = 0.3) -> np.ndarray:
    scale = 1.0 + rng.uniform(-strength, strength, size=(1, 1, 3))
    shift = rng.uniform(-strength, strength, size=(1, 1, 3)) * 30
    return np.clip(img.astype(np.float64) * scale + shift, 0, 255).astype(np.uint8)


def random_lines(img: np.ndarray, rng: np.random.Generator,
                 num_lines: int = 8) -> np.ndarray:
    """Scribble random lines (`image_helper.py` ``opencvRandomLines``)."""
    im = Image.fromarray(np.asarray(img, np.uint8))
    draw = ImageDraw.Draw(im)
    h, w = img.shape[0], img.shape[1]
    for _ in range(int(rng.integers(1, num_lines + 1))):
        x1, x2 = rng.integers(0, w, 2)
        y1, y2 = rng.integers(0, h, 2)
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        draw.line([(int(x1), int(y1)), (int(x2), int(y2))], fill=color,
                  width=int(rng.integers(1, 4)))
    return np.asarray(im)


def crop(img: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> np.ndarray:
    return img[y1:y2, x1:x2]


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
