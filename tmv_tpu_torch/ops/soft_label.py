"""Gaussian-heatmap soft labels for keypoint regression (UNet family).

Port of ``tmv_tpu/ops/soft_label.py`` (the reference's `unet/soft_label.py:10-60`
and `unet/gaussian_kernel_2d.py:5-47`): each keypoint becomes an impulse in its
own channel, convolved with one shared analytic 2-D Gaussian kernel applied
depthwise over the point channels and max-normalized per channel. A point out
of range gives an all-zero channel (the reference skips its scatter and then
divides 0 by 0; the JAX package keeps zeros, and so does the port).
"""

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tmv_tpu_torch.models.layers.common import same_pads


def gaussian_2d(points, sigma: float = 1.0):
    """Gaussian value per ``[..., (y, x)]`` point (numpy or torch), with the
    reference's quirk: the coordinates are pre-scaled by ``2 * sigma``."""
    y = points[..., 0] * 2.0 * sigma
    x = points[..., 1] * 2.0 * sigma
    return 1.0 / (2.0 * math.pi * sigma ** 2) * math.e ** -((y * y + x * x) / (2.0 * sigma ** 2))


def gaussian_kernel_2d(shape: Tuple[int, int, int, int], sigma: float = 1.0) -> np.ndarray:
    """Analytic Gaussian kernel ``(h, w, in_filters, out_filters)`` float32, on
    a grid spanning [-1, 1) scaled by the half-size."""
    h, w, in_f, out_f = shape
    h_half, w_half = h // 2, w // 2
    y = np.arange(-h_half, h - h_half, dtype=np.float32) / h_half
    x = np.arange(-w_half, w - w_half, dtype=np.float32) / w_half
    xv, yv = np.meshgrid(x, y)
    pts = np.stack([yv, xv], axis=-1)[:, :, None, None, :]
    pts = np.tile(pts, (1, 1, in_f, out_f, 1))
    return np.asarray(gaussian_2d(pts, sigma), np.float32)


class SoftLabel:
    """Keypoints → per-point Gaussian heatmaps."""

    def __init__(self, image_size: Tuple[int, int], points_num: int,
                 kernel_size: Tuple[int, int], sigma: float = 1.0):
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.points_num = points_num
        self.kernel_size = (int(kernel_size[0]), int(kernel_size[1]))
        # one shared 2-D kernel, applied depthwise over the point channels
        self.kernel = torch.from_numpy(
            gaussian_kernel_2d((*self.kernel_size, 1, 1), sigma)[:, :, 0, 0])

    def get_target(self, points: torch.Tensor) -> torch.Tensor:
        """``(points_num, (y, x))`` int points → ``(H, W, points_num)`` float32
        heatmaps on the points' device."""
        h, w = self.image_size
        p = self.points_num
        dev = points.device
        py, px = points[:, 0].long(), points[:, 1].long()
        in_range = (py >= 0) & (px >= 0) & (py < h) & (px < w)
        impulses = torch.zeros((p, h, w), dtype=torch.float32, device=dev)
        chan = torch.arange(p, device=dev)
        impulses[chan, torch.where(in_range, py, 0), torch.where(in_range, px, 0)] = \
            in_range.float()
        kh, kw = self.kernel_size
        (top, bottom), (left, right) = same_pads(h, kh, 1), same_pads(w, kw, 1)
        kernel = self.kernel.to(dev).expand(p, 1, kh, kw)
        out = F.conv2d(F.pad(impulses[None], (left, right, top, bottom)), kernel, groups=p)[0]
        peak = out.amax(dim=(1, 2), keepdim=True)
        out = torch.where(peak > 0, out / torch.where(peak > 0, peak, torch.ones_like(peak)),
                          torch.zeros_like(out))
        return out.permute(1, 2, 0)
