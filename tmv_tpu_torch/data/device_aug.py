"""EfficientDet's augmentation on the device: blur, affine warp and noise, batched.

Port of ``tmv_tpu/data/device_aug.py`` (the ``--deviceAug`` path): the host only
decodes and letterboxes to the network frame, and the chain runs on the
pipeline's device over the whole batch, in the target frame:

- Gaussian blur of a per-image integer radius in [0, 4] (separable 17-tap
  kernel, edge-extended as PIL; radius 0 is the identity kernel);
- an axis-aligned affine warp, scale in [0.5, 2) and offset in [−45, 45) px
  about the frame centre, bilinear, zero outside the source (PIL's pixel-centre
  convention), with the boxes moved by the same map and clipped to the frame;
- salt-and-pepper noise: 2% of the pixels replaced by a uniform random colour;
- boxes narrower or shorter than 2 px become invalid.

As the YOLO pipeline does (``data/yolo_pipeline.py::draw_augment_params``), the
draws are split from their application: ``draw_params`` draws each image's
numbers from a ``torch.Generator``, ``augment_batch`` applies given numbers, so
a caller can feed the numbers JAX drew from its keys.
"""

from typing import Dict

import torch
import torch.nn.functional as F

BLUR_HALF_WIDTH = 8   # a 17-tap kernel covers sigma <= 4, the largest radius


def draw_params(gen: torch.Generator, n: int, image_size: int, blur_max: int = 4,
                noise_amount: float = 0.02) -> Dict[str, torch.Tensor]:
    """The draws of ``n`` images on the generator's device: ``radius`` ``(n,)``
    int in [0, blur_max], ``scale`` ``(n, 2)`` (sx, sy) in [0.5, 2), ``offset``
    ``(n, 2)`` (dx, dy) in [−45, 45), ``noise`` ``(n, S, S, 1)`` bool (a pixel is
    replaced with probability ``noise_amount``) and ``colors`` ``(n, S, S, 3)``
    uniform [0, 1)."""
    dev = gen.device
    s = image_size
    return {
        "radius": torch.randint(0, blur_max + 1, (n,), generator=gen, device=dev),
        "scale": torch.rand((n, 2), generator=gen, device=dev) * 1.5 + 0.5,
        "offset": torch.rand((n, 2), generator=gen, device=dev) * 90.0 - 45.0,
        "noise": torch.rand((n, s, s, 1), generator=gen, device=dev) < noise_amount,
        "colors": torch.rand((n, s, s, 3), generator=gen, device=dev),
    }


def gaussian_blur(img: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of ``(B, H, W, C)`` float images by per-image
    ``radius`` ``(B,)`` (PIL's radius ≈ sigma; below 0.5 the identity), borders
    edge-extended: two grouped convs with one kernel per image and channel."""
    b, h, w, c = img.shape
    offs = torch.arange(-BLUR_HALF_WIDTH, BLUR_HALF_WIDTH + 1, dtype=torch.float32,
                        device=img.device)
    r = radius.to(torch.float32)[:, None]
    sigma = torch.clamp_min(r, 1e-3)
    k = torch.exp(-0.5 * torch.square(offs / sigma))
    k = torch.where(r < 0.5, (offs == 0).to(torch.float32), k)
    k = k / torch.sum(k, dim=-1, keepdim=True)                                    # (B, 17)
    taps = k.repeat_interleave(c, dim=0)                                          # (B·C, 17)
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.pad(x, (BLUR_HALF_WIDTH,) * 4, mode="replicate")
    x = F.conv2d(x, taps[:, None, :, None], groups=b * c)
    x = F.conv2d(x, taps[:, None, None, :], groups=b * c)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def affine_warp(img: torch.Tensor, sx, sy, dx, dy) -> torch.Tensor:
    """Axis-aligned affine warp of ``(B, H, W, C)`` images about their centre by
    per-image ``(B,)`` scales and offsets: ``out(x, y) = in((x − tx)/sx, (y −
    ty)/sy)`` with ``tx = dx + W/2·(1 − sx)``, ``ty = dy + H/2·(1 − sy)``;
    bilinear at PIL's pixel centres, zero outside the source."""
    b, h, w = img.shape[0], img.shape[1], img.shape[2]
    dev = img.device
    tx = dx + w / 2.0 * (1.0 - sx)
    ty = dy + h / 2.0 * (1.0 - sy)
    src_x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 - tx[:, None]) \
        / sx[:, None] - 0.5                                                       # (B, W)
    src_y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5 - ty[:, None]) \
        / sy[:, None] - 0.5                                                       # (B, H)
    in_x = (src_x >= 0) & (src_x <= w - 1)
    in_y = (src_y >= 0) & (src_y <= h - 1)
    x0 = torch.clamp(torch.floor(src_x), 0, w - 1)
    y0 = torch.clamp(torch.floor(src_y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (torch.clamp(src_x, 0, w - 1) - x0)[:, None, :, None]
    wy = (torch.clamp(src_y, 0, h - 1) - y0)[:, :, None, None]
    imgf = img.float()
    bi = torch.arange(b, device=dev)[:, None, None]

    def at(yi, xi):
        return imgf[bi, yi.long()[:, :, None], xi.long()[:, None, :]]              # (B, H, W, C)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    mask = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(mask, out, torch.zeros_like(out))


def affine_boxes(boxes: torch.Tensor, hw, sx, sy, dx, dy) -> torch.Tensor:
    """``(B, N, 4)`` xyxy boxes through ``affine_warp``'s map, clipped to the frame."""
    h, w = hw
    tx = dx + w / 2.0 * (1.0 - sx)
    ty = dy + h / 2.0 * (1.0 - sy)
    # one rounding of b·s + t, as XLA's fused multiply-add rounds it
    out = (boxes.double() * torch.stack([sx, sy, sx, sy], -1)[:, None, :].double()
           + torch.stack([tx, ty, tx, ty], -1)[:, None, :].double()).float()
    limit = torch.tensor([w, h, w, h], dtype=torch.float32, device=boxes.device)
    return torch.minimum(torch.maximum(out, torch.zeros_like(out)), limit)


def augment_batch(images_u8: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                  params: Dict[str, torch.Tensor], image_size: int):
    """The chain over a staged batch: ``images_u8`` ``(B, S, S, 3)`` uint8
    letterboxed frames, ``boxes`` ``(B, N, 4)`` xyxy frame pixels, ``valid``
    ``(B, N)``, ``params`` the draws of ``draw_params``. Returns float32 [0, 1]
    images, the moved boxes (xyxy) and ``valid`` without boxes under 2 px."""
    img01 = images_u8.to(torch.float32) / 255.0
    img01 = gaussian_blur(img01, params["radius"])
    sx, sy = params["scale"].unbind(-1)
    dx, dy = params["offset"].unbind(-1)
    img01 = affine_warp(img01, sx, sy, dx, dy)
    boxes = affine_boxes(boxes.to(torch.float32), (image_size, image_size), sx, sy, dx, dy)
    img01 = torch.where(params["noise"], params["colors"], img01)
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    valid = valid.bool() & (wh[..., 0] >= 2) & (wh[..., 1] >= 2)
    return torch.clamp(img01, 0.0, 1.0), boxes, valid
