"""Batched 4-image mosaic augmentation on the device.

Port of ``tmv_tpu/data/mosaic.py``. Output image ``i`` composes the staged batch
images ``(i, p1[i], p2[i], p3[i])`` (three partner permutations, no extra
decode). A center ``(cx, cy)`` splits the canvas into the TL/TR/BL/BR rects;
each source's whole frame is mapped affinely into its rect, and every output
pixel takes a bilinear inverse-affine gather from the source of its quadrant.
Boxes ride the same affines, are clipped to their rect and stay valid only if
wider and taller than 1 px; the 4N boxes are compacted back to N, valid boxes
first and the largest area first.

As the YOLO pipeline's augmentation, the draws are split from their
application: ``draw_mosaic_params`` draws the partners, centers and per-image
gate on the CPU from a ``torch.Generator``, and ``mosaic_batch`` applies given
draws. Given the same draws the result is the JAX function's: the compaction
is a stable descending sort, so among equal ranks (every invalid row ranks
−1) the lower index comes first, as ``jax.lax.top_k`` puts it; an integer
image is cast back by truncation, as ``astype`` does.
"""

from typing import Tuple

import torch


def draw_mosaic_params(gen: torch.Generator, b: int, frame_wh: Tuple[int, int],
                       center_range: Tuple[float, float] = (0.3, 0.7), prob: float = 1.0):
    """The draws of one batch of ``b`` images of ``frame_wh = (W, H)``:
    ``partners`` ``(3, B)`` int64 (three random permutations), ``centers``
    ``(B, 2)`` float32 pixels ``(cx, cy)`` uniform in ``center_range`` of
    ``(W, H)``, and ``gate`` ``(B,)`` bool, each image replaced by its mosaic
    with probability ``prob``. CPU tensors."""
    partners = torch.stack([torch.randperm(b, generator=gen) for _ in range(3)])
    lo, hi = center_range
    frac = torch.rand((b, 2), generator=gen) * (hi - lo) + lo
    centers = frac * torch.tensor([float(frame_wh[0]), float(frame_wh[1])])
    gate = torch.rand((b,), generator=gen) < prob
    return partners, centers, gate


def _sample_coords(pos: torch.Tensor, start: torch.Tensor, extent: torch.Tensor, size: int):
    """Source coordinates of output pixels ``pos`` in a tile starting at
    ``start`` of ``extent`` pixels (content fit of ``size`` pixels), and their
    two clamped integer neighbours and weight, as ``_bilinear_sample``."""
    extent = torch.clamp(extent, min=1.0)
    # a tensor divided into, not ``size / extent``: torch computes a Python
    # number over a tensor as a reciprocal times the number, one rounding more
    src = (pos - start) * (torch.full_like(extent, float(size)) / extent)
    lo = torch.clamp(torch.floor(src), 0, size - 1)
    hi = torch.clamp(lo + 1, 0, size - 1)
    weight = torch.clamp(src, 0, size - 1) - lo
    return lo.long(), hi.long(), weight


def mosaic_batch(images: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
                 valid: torch.Tensor, partners: torch.Tensor, centers: torch.Tensor,
                 gate: torch.Tensor):
    """Apply the draws of ``draw_mosaic_params`` to a staged batch.

    ``images`` ``(B, H, W, 3)`` (uint8 or float, any range), ``boxes`` ``(B, N,
    4)`` pixel xyxy, ``classes`` and ``valid`` ``(B, N)``. Returns ``(images,
    boxes, classes, valid)`` of the same shapes and types, on the images'
    device; images where ``gate`` is false pass through.
    """
    dev = images.device
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    n = boxes.shape[1]
    partners, centers, gate = partners.to(dev), centers.to(dev, torch.float32), gate.to(dev)
    idx = torch.cat([torch.arange(b, device=dev)[None], partners.long()], 0).t()   # (B, 4)
    cx, cy = centers[:, 0], centers[:, 1]
    zero = torch.zeros_like(cx)
    wf, hf = torch.full_like(cx, float(w)), torch.full_like(cy, float(h))
    # quadrant rects (x0, y0, x1, y1) per image, TL, TR, BL, BR: (B, 4) each
    x0 = torch.stack([zero, cx, zero, cx], 1)
    y0 = torch.stack([zero, zero, cy, cy], 1)
    x1 = torch.stack([cx, wf, cx, wf], 1)
    y1 = torch.stack([cy, cy, hf, hf], 1)

    # pixels: a row lies in the top or bottom rects, a column in the left or right
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    bottom = ys[None, :] >= cy[:, None]                                   # (B, H)
    right = xs[None, :] >= cx[:, None]                                    # (B, W)
    ry0 = torch.where(bottom, cy[:, None], 0.0)
    ry1 = torch.where(bottom, float(h), cy[:, None])
    rx0 = torch.where(right, cx[:, None], 0.0)
    rx1 = torch.where(right, float(w), cx[:, None])
    ylo, yhi, wy = _sample_coords(ys[None, :], ry0, ry1 - ry0, h)
    xlo, xhi, wx = _sample_coords(xs[None, :], rx0, rx1 - rx0, w)
    quadrant = bottom.long()[:, :, None] * 2 + right.long()[:, None, :]   # (B, H, W)
    source = torch.gather(idx, 1, quadrant.view(b, -1)).view(b, h, w)
    imgs_f = images.float()

    def at(yi, xi):
        return imgs_f[source, yi[:, :, None], xi[:, None, :]]            # (B, H, W, 3)

    wx3, wy3 = wx[:, None, :, None], wy[:, :, None, None]
    top = at(ylo, xlo) * (1 - wx3) + at(ylo, xhi) * wx3
    bot = at(yhi, xlo) * (1 - wx3) + at(yhi, xhi) * wx3
    m_img = top * (1 - wy3) + bot * wy3

    # boxes: the same affine per quadrant, clipped to the rect
    sx = torch.clamp(x1 - x0, min=1.0) / w
    sy = torch.clamp(y1 - y0, min=1.0) / h
    scale = torch.stack([sx, sy, sx, sy], -1)[:, :, None, :]              # (B, 4, 1, 4)
    lo = torch.stack([x0, y0, x0, y0], -1)[:, :, None, :]
    hi = torch.stack([x1, y1, x1, y1], -1)[:, :, None, :]
    src_boxes = boxes.float()[idx]                                        # (B, 4, N, 4)
    mapped = torch.minimum(torch.maximum(src_boxes * scale + lo, lo), hi)
    bw = mapped[..., 2] - mapped[..., 0]
    bh = mapped[..., 3] - mapped[..., 1]
    m_valid = valid.bool()[idx] & (bw > 1) & (bh > 1)
    all_boxes = mapped.reshape(b, 4 * n, 4)
    all_valid = m_valid.reshape(b, 4 * n)
    all_classes = classes[idx].reshape(b, 4 * n)

    # compact 4N → N: valid first, the largest area first among them
    area = ((all_boxes[..., 2] - all_boxes[..., 0]) * (all_boxes[..., 3] - all_boxes[..., 1]))
    rank = torch.where(all_valid, area, torch.full_like(area, -1.0))
    sel = torch.sort(rank, dim=1, descending=True, stable=True).indices[:, :n]
    m_boxes = torch.gather(all_boxes, 1, sel[..., None].expand(b, n, 4))
    m_classes = torch.gather(all_classes, 1, sel)
    m_valid = torch.gather(all_valid, 1, sel)

    out_img = torch.where(gate[:, None, None, None], m_img, imgs_f)
    out_boxes = torch.where(gate[:, None, None], m_boxes, boxes.float()).to(boxes.dtype)
    out_classes = torch.where(gate[:, None], m_classes, classes)
    out_valid = torch.where(gate[:, None], m_valid, valid.bool()).to(valid.dtype)
    return out_img.to(images.dtype), out_boxes, out_classes, out_valid
