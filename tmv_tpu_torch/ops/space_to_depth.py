"""Space-to-depth form of the EfficientNet stem (``Stem(stem_s2d=True)``).

Port of ``tmv_tpu/ops/space_to_depth.py`` on the port's layouts. The stem's 3x3
stride-2 TF-SAME conv on an (H, W, 3) image is re-expressed as

    space_to_depth(x, 2)            # (B, 3, H, W) -> (B, 12, H/2, W/2)
    conv 2x2 stride 1, pads (0, 1)  # the 3x3 kernel zero-padded to 4x4, regrouped

the same contraction up to float reassociation (the checkpoint keeps the 3x3 kernel;
the rearrangement is made at each call). Valid for even H and W, where SAME pads a
k=3, s=2 conv by (0, 1); every D-config input size is even. In the JAX package it is
an opt-in TPU layout move, off by default; the port keeps it for the configs that set
``stem_s2d``.
"""

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``(B, C, H, W)`` → ``(B, b·b·C, H/b, W/b)``, channels in ``[dy, dx, c]`` order
    (row offset major), as JAX's NHWC ``space_to_depth``."""
    b, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: {h}x{w} is not divisible by {block}")
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, block * block * c, h // block, w // block)


def stem_kernel_to_s2d(w3: torch.Tensor) -> torch.Tensor:
    """A ``(F, C, 3, 3)`` stride-2 kernel → the equivalent ``(F, 4C, 2, 2)`` stride-1
    kernel over ``space_to_depth(x, 2)``: zero-padded to 4x4, then split into the
    four ``(dy, dx)`` parity planes (input channel ``dy·2C + dx·C + c``)."""
    f, c, kh, kw = w3.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"stem_kernel_to_s2d: a 3x3 kernel, got {kh}x{kw}")
    w4 = F.pad(w3, (0, 1, 0, 1))                               # (F, C, 4, 4)
    # [f, c, 2·dy' + dy, 2·dx' + dx] → [f, dy, dx, c, dy', dx']
    w2 = w4.reshape(f, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)
    return w2.reshape(f, 4 * c, 2, 2)


def s2d_stem_conv(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 stride-2 SAME conv of ``x`` with ``w3``, computed as a 2x2
    stride-1 conv over ``space_to_depth(x, 2)`` padded (0, 1) → channels_last."""
    y = F.conv2d(F.pad(space_to_depth(x, 2), (0, 1, 0, 1)), stem_kernel_to_s2d(w3))
    return y.contiguous(memory_format=torch.channels_last)
