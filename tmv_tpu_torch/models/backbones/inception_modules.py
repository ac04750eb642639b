"""Shared Inception building blocks.

Port of ``tmv_tpu/models/backbones/inception_modules.py``: ``BasicConv2D``
(conv with a bias → BatchNorm → relu), ``Conv2DLinear`` (conv → BatchNorm), the
pools, the InceptionV4/IRv2 ``InceptionStem``, ``InceptionBlockA/B/C``,
``ReductionA`` (k, l, m, n) and the V4 ``ReductionBV4``.

Modules take NCHW (``channels_last`` memory) and concatenate branches on dim 1,
in the flax order. Submodules carry the flax auto-names, numbered per class in
call order (``BasicConv2D_k/Conv_0``, ``BatchNorm_0``, ``Conv2DLinear_0``), so
``convert.flax_bridge`` maps a flax tree onto them by path. The BatchNorms are
``layers.common.BatchNorm`` (momentum 0.99, epsilon 1e-3, flax's running
statistics update).

- Every "SAME" conv of these nets runs at stride 1 with odd kernels ((1, 7),
  (7, 1), (1, 3), 3 × 3), where TF-SAME pads ``k // 2`` on both sides: the conv
  pads symmetrically. A stride-2 conv is "VALID".
- ``avg_pool_same`` is flax's ``nn.avg_pool(..., padding="SAME")``, which divides
  every window by its full 9 taps, zero pads included (``count_include_pad``),
  where Keras would leave the pads out.
"""

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.models.layers.common import BatchNorm


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2DLinear(nn.Module):
    """Conv (bias) → BatchNorm, "SAME" (stride 1) or "VALID"."""

    def __init__(self, in_features: int, filters: int, kernel_size, strides: int = 1,
                 padding: str = "SAME", device=None):
        super().__init__()
        kernel = _pair(kernel_size)
        if padding == "SAME":
            if strides != 1 or not all(k % 2 for k in kernel):
                raise ValueError(f"SAME padding is symmetric here: stride 1 and odd kernels, "
                                 f"not stride {strides}, kernel {kernel}")
            pads = (kernel[0] // 2, kernel[1] // 2)
        elif padding == "VALID":
            pads = (0, 0)
        else:
            raise ValueError(f"padding {padding!r}")
        self.Conv_0 = nn.Conv2d(in_features, filters, kernel, strides, pads, device=device)
        self.BatchNorm_0 = BatchNorm(filters, eps=1e-3, momentum=0.01, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(self.Conv_0(x))


class BasicConv2D(Conv2DLinear):
    """Conv (bias) → BatchNorm → relu."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(super().forward(x))


def basic_convs(parent: nn.Module, specs: Sequence[tuple], device=None) -> tuple:
    """Register ``BasicConv2D_{i}`` on ``parent`` for each spec ``(in, filters,
    kernel[, strides[, padding]])`` in flax's call order; returns them in order."""
    convs = []
    for i, spec in enumerate(specs):
        conv = BasicConv2D(*spec, device=device)
        parent.add_module(f"BasicConv2D_{i}", conv)
        convs.append(conv)
    return tuple(convs)


def max_pool_valid(x: torch.Tensor, window: int = 3, strides: int = 2) -> torch.Tensor:
    return F.max_pool2d(x, window, strides)


def avg_pool_same(x: torch.Tensor, window: int = 3, strides: int = 1) -> torch.Tensor:
    """3 × 3 stride-1 average with the zero pads counted (flax's SAME average)."""
    return F.avg_pool2d(x, window, strides, padding=window // 2, count_include_pad=True)


class InceptionStem(nn.Module):
    """InceptionV4/IRv2 stem: 3 → 384 channels."""

    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [
            (3, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"), (32, 64, 3), (64, 96, 3, 2, "VALID"),
            (160, 64, 1), (64, 96, 3, 1, "VALID"),
            (160, 64, 1), (64, 64, (7, 1)), (64, 64, (1, 7)), (64, 96, 3, 1, "VALID"),
            (192, 192, 3, 2, "VALID")], device)

    def forward(self, x):
        c = self.c
        x = c[2](c[1](c[0](x)))
        x = torch.cat([max_pool_valid(x), c[3](x)], 1)
        b3 = c[5](c[4](x))
        b4 = c[9](c[8](c[7](c[6](x))))
        x = torch.cat([b3, b4], 1)
        return torch.cat([c[10](x), max_pool_valid(x)], 1)


class InceptionBlockA(nn.Module):
    def __init__(self, in_features: int = 384, device=None):
        super().__init__()
        i = in_features
        self.c = basic_convs(self, [(i, 96, 1), (i, 96, 1), (i, 64, 1), (64, 96, 3),
                                    (i, 64, 1), (64, 96, 3), (96, 96, 3)], device)

    def forward(self, x):
        c = self.c
        return torch.cat([c[0](avg_pool_same(x)), c[1](x), c[3](c[2](x)), c[6](c[5](c[4](x)))], 1)


class InceptionBlockB(nn.Module):
    def __init__(self, in_features: int = 1024, device=None):
        super().__init__()
        i = in_features
        self.c = basic_convs(self, [
            (i, 128, 1), (i, 384, 1), (i, 192, 1), (192, 224, (1, 7)), (224, 256, (1, 7)),
            (i, 192, 1), (192, 192, (1, 7)), (192, 224, (7, 1)), (224, 224, (1, 7)),
            (224, 256, (7, 1))], device)

    def forward(self, x):
        c = self.c
        return torch.cat([c[0](avg_pool_same(x)), c[1](x), c[4](c[3](c[2](x))),
                          c[9](c[8](c[7](c[6](c[5](x)))))], 1)


class InceptionBlockC(nn.Module):
    def __init__(self, in_features: int = 1536, device=None):
        super().__init__()
        i = in_features
        self.c = basic_convs(self, [
            (i, 256, 1), (i, 256, 1), (i, 384, 1), (384, 256, (1, 3)), (384, 256, (3, 1)),
            (i, 384, 1), (384, 448, (1, 3)), (448, 512, (3, 1)), (512, 256, (3, 1)),
            (512, 256, (1, 3))], device)

    def forward(self, x):
        c = self.c
        b3 = c[2](x)
        b4 = c[7](c[6](c[5](x)))
        return torch.cat([c[0](avg_pool_same(x)), c[1](x), c[3](b3), c[4](b3), c[8](b4),
                          c[9](b4)], 1)


class ReductionA(nn.Module):
    """in → in + n + m channels at half the size."""

    def __init__(self, in_features: int, k: int, l: int, m: int, n: int, device=None):
        super().__init__()
        self.c = basic_convs(self, [(in_features, n, 3, 2, "VALID"), (in_features, k, 1),
                                    (k, l, 3), (l, m, 3, 2, "VALID")], device)

    def forward(self, x):
        c = self.c
        return torch.cat([max_pool_valid(x), c[0](x), c[3](c[2](c[1](x)))], 1)


class ReductionBV4(nn.Module):
    """InceptionV4's ReductionB: 1024 → 1536 channels."""

    def __init__(self, in_features: int = 1024, device=None):
        super().__init__()
        i = in_features
        self.c = basic_convs(self, [
            (i, 192, 1), (192, 192, 3, 2, "VALID"), (i, 256, 1), (256, 256, (1, 7)),
            (256, 320, (7, 1)), (320, 320, 3, 2, "VALID")], device)

    def forward(self, x):
        c = self.c
        return torch.cat([max_pool_valid(x), c[1](c[0](x)), c[5](c[4](c[3](c[2](x))))], 1)
