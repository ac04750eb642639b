"""Stochastic regularizers: drop_connect, DropBlock, Disout.

Port of ``tmv_tpu/ops/regularizers.py`` (the reference's
`utils/drop_connect.py:3-19`, live in EfficientDet's heads, and the dormant
`utils/drop_block.py:4-59` and `utils/disout.py:4-162`). JAX draws from explicit
PRNG keys; here every function takes its uniform [0, 1) draws as tensors, so a
test feeds JAX's and a caller draws them from its ``torch.Generator``
(``center_shape`` gives the block centres' shape). The 2-D functions take the
port's NCHW activations; their draws are NCHW too (JAX's NHWC draws permuted).
"""

import torch
import torch.nn.functional as F


def drop_connect(x: torch.Tensor, survival_prob: float, uniform: torch.Tensor) -> torch.Tensor:
    """Stochastic depth (train time only): ``x / p · floor(p + u)`` with ``u``
    the ``(B, 1, …)`` uniform draws and ``p = survival_prob`` rounded to x's
    dtype, as JAX rounds the Python scalar, so each sample's branch is dropped
    or divided by ``p`` (`utils/drop_connect.py:10-19`)."""
    if survival_prob >= 1.0:
        return x
    p = uniform.new_full((), survival_prob)
    return x / p * torch.floor(p + uniform)


def block_size_of(height: int, block_size: int) -> int:
    """The block edge the reference uses on a map of ``height`` rows."""
    return min(block_size, (height // 5) + 1 if block_size > height // 5 else block_size)


def center_shape(x: torch.Tensor, block_size: int):
    """Shape of the block-centre draws of an NCHW ``x``: ``(B, C, H − bs + 1,
    W − bs + 1)``."""
    b, c, h, w = x.shape
    bs = block_size_of(h, block_size)
    return (b, c, h - bs + 1, w - bs + 1)


def _max_same(seeds: torch.Tensor, bs: int) -> torch.Tensor:
    """``reduce_window(max, bs, stride 1, SAME)`` over the last ``seeds.dim() −
    2`` axes, padded with −inf (lower pad ``(bs − 1) // 2``), floored at 0."""
    lo = (bs - 1) // 2
    pads = (lo, bs - 1 - lo) * (seeds.dim() - 2)
    padded = F.pad(seeds, pads, value=float("-inf"))
    pool = F.max_pool2d if seeds.dim() == 4 else F.max_pool1d
    return torch.clamp(pool(padded, bs, 1), min=0.0)


def _block_mask(x_shape, centers: torch.Tensor, block_size: int, dist_prob: float):
    """DropBlock/Disout's mask: seed centres in the interior, max-pooled to
    square blocks (`utils/drop_block.py:28-52`). The border band is padded with
    1.0 (no seed), the JAX package's deliberate fix of the reference, whose zero
    pad seeds every border pixel."""
    _, _, h, w = x_shape
    bs = block_size_of(h, block_size)
    block_num = (h * w) * dist_prob / (bs * bs)
    block_rate = block_num / ((h - bs + 1) * (w - bs + 1))
    pad_t = pad_l = bs // 2
    pad_b = h - pad_t - (h - bs + 1)
    pad_r = w - pad_l - (w - bs + 1)
    padded = F.pad(centers, (pad_l, pad_r, pad_t, pad_b), value=1.0)
    return _max_same((padded < block_rate).to(centers.dtype), bs)


def drop_block(x: torch.Tensor, training: bool, dist_prob: float, centers: torch.Tensor,
               block_size: int = 5) -> torch.Tensor:
    """DropBlock: zero contiguous spatial blocks of an NCHW ``x``; ``centers``
    has ``center_shape(x, block_size)``."""
    if not training or x.dim() != 4:
        return x
    return x * (1.0 - _block_mask(x.shape, centers, block_size, dist_prob))


def disout(x: torch.Tensor, training: bool, dist_prob: float, centers: torch.Tensor,
           noise: torch.Tensor, block_size: int = 5, alpha: float = 1.0) -> torch.Tensor:
    """Disout (arXiv 2002.11022) on an NCHW ``x``: blocked positions blend
    toward uniform noise in each channel's [min, max] with strength ``alpha·v +
    0.3``, ``v`` the channel-summed magnitude over the per-image sum of channel
    maxima (`utils/disout.py:22-97`). ``centers`` has ``center_shape(x,
    block_size)``, ``noise`` x's shape."""
    if not training or x.dim() != 4:
        return x
    block = _block_mask(x.shape, centers, block_size, dist_prob)
    x_abs = torch.abs(x)
    x_sum = torch.sum(x_abs, dim=1, keepdim=True)
    x_max_c = torch.amax(x_abs, dim=(2, 3), keepdim=True)
    x_sum_c = torch.sum(x_max_c, dim=1, keepdim=True)
    x_v = x_sum / x_sum_c
    x_max = torch.amax(x, dim=(2, 3), keepdim=True)
    x_min = torch.amin(x, dim=(2, 3), keepdim=True)
    noise = noise * (x_max - x_min) + x_min
    mixed = noise * (alpha * x_v + 0.3) + x * (1.0 - alpha * x_v - 0.3)
    return x * (1.0 - block) + mixed * block


def disout_1d(x: torch.Tensor, training: bool, dist_prob: float, centers: torch.Tensor,
              noise: torch.Tensor, block_size: int = 5, alpha: float = 0.5) -> torch.Tensor:
    """1-D Disout over ``(B, N)`` feature vectors (`utils/disout.py:105-162`):
    ``centers`` is ``(B, N − block_size + 1)``, ``noise`` x's shape. The border
    band is zero-padded as in the reference, so where the rate is positive every
    border position seeds a block."""
    if not training or x.dim() != 2:
        return x
    n = x.shape[1]
    bs = block_size
    block_rate = (n * dist_prob / bs) / (n - bs + 1)
    pad_t = bs // 2
    pad_b = n - pad_t - (n - bs + 1)
    padded = F.pad(centers, (pad_t, pad_b))
    block = _max_same((padded < block_rate).to(centers.dtype)[:, None], bs)[:, 0]
    x_max = torch.amax(x, dim=1, keepdim=True)
    x_min = torch.amin(x, dim=1, keepdim=True)
    noise = noise * (x_max - x_min) + x_min
    mixed = noise * (1.0 - alpha) + x * alpha
    return x * (1.0 - block) + mixed * block
