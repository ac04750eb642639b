"""InceptionResNetV1, FaceNet's default backbone.

Port of ``tmv_tpu/models/backbones/inception_resnet_v1.py``: the FaceNet stem,
5 × A, ReductionA(192, 192, 256, 384), 10 × B, ReductionBV1, 5 × C, then the mean
over H and W, ``Dropout(0.2)`` and ``Dense(classes)``. The residual adds are
unscaled and followed by relu, as in the reference. Submodules carry the flax
names (``StemV1_0``, ``InceptionResNetA_{i}``, ``ReductionA_0``, …,
``Dense_0``). NCHW in; ``remat=True`` runs each A, B and C block under
``layers.common.remat_call`` in train mode, as the JAX package wraps them in
``nn.remat``.

Dropout draws its keep mask from an explicit ``torch.Generator`` (``dropout``):
``F.dropout`` takes none.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.models.backbones.inception_modules import (
    Conv2DLinear,
    ReductionA,
    basic_convs,
    max_pool_valid,
)
from tmv_tpu_torch.models.layers.common import remat_call


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(keep, x / (1 − rate), 0)``, flax's dropout given its mask."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not training)``: the identity in
    eval mode or at rate 0, zeros at rate 1, else the keep mask ``uniform < 1 −
    rate`` drawn from ``generator`` (train-mode dropout needs one)."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("train-mode dropout draws from an explicit torch.Generator; got None")
    keep = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device) < 1.0 - rate
    return apply_dropout(x, keep, rate)


class StemV1(nn.Module):
    """3 → 256 channels: 160 px → 17 × 17."""

    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [
            (3, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"), (32, 64, 3), (64, 80, 1),
            (80, 192, 3, 1, "VALID"), (192, 256, 3, 2, "VALID")], device)

    def forward(self, x):
        c = self.c
        x = max_pool_valid(c[2](c[1](c[0](x))))
        return c[5](c[4](c[3](x)))


class InceptionResNetA(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [(256, 32, 1), (256, 32, 1), (32, 32, 3), (256, 32, 1),
                                    (32, 32, 3), (32, 32, 3)], device)
        self.Conv2DLinear_0 = Conv2DLinear(96, 256, 1, device=device)

    def forward(self, x):
        c = self.c
        y = torch.cat([c[0](x), c[2](c[1](x)), c[5](c[4](c[3](x)))], 1)
        return F.relu(self.Conv2DLinear_0(y) + x)


class InceptionResNetB(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [(896, 128, 1), (896, 128, 1), (128, 128, (1, 7)),
                                    (128, 128, (7, 1))], device)
        self.Conv2DLinear_0 = Conv2DLinear(256, 896, 1, device=device)

    def forward(self, x):
        c = self.c
        y = torch.cat([c[0](x), c[3](c[2](c[1](x)))], 1)
        return F.relu(self.Conv2DLinear_0(y) + x)


class ReductionBV1(nn.Module):
    """896 → 1792 channels at half the size."""

    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [
            (896, 256, 1), (256, 384, 3, 2, "VALID"), (896, 256, 1), (256, 256, 3, 2, "VALID"),
            (896, 256, 1), (256, 256, 3), (256, 256, 3, 2, "VALID")], device)

    def forward(self, x):
        c = self.c
        return torch.cat([max_pool_valid(x), c[1](c[0](x)), c[3](c[2](x)),
                          c[6](c[5](c[4](x)))], 1)


class InceptionResNetC(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [(1792, 192, 1), (1792, 192, 1), (192, 192, (1, 3)),
                                    (192, 192, (3, 1))], device)
        self.Conv2DLinear_0 = Conv2DLinear(384, 1792, 1, device=device)

    def forward(self, x):
        c = self.c
        y = torch.cat([c[0](x), c[3](c[2](c[1](x)))], 1)
        return F.relu(self.Conv2DLinear_0(y) + x)


class InceptionResNetV1(nn.Module):
    """NCHW images → ``(B, classes)``; ``generator`` feeds train-mode dropout."""

    def __init__(self, classes: int, dropout_rate: float = 0.2, device=None,
                 remat: bool = False):
        super().__init__()
        self.dropout_rate, self.remat = dropout_rate, remat
        self.StemV1_0 = StemV1(device)
        for i in range(5):
            self.add_module(f"InceptionResNetA_{i}", InceptionResNetA(device))
        self.ReductionA_0 = ReductionA(256, 192, 192, 256, 384, device)
        for i in range(10):
            self.add_module(f"InceptionResNetB_{i}", InceptionResNetB(device))
        self.ReductionBV1_0 = ReductionBV1(device)
        for i in range(5):
            self.add_module(f"InceptionResNetC_{i}", InceptionResNetC(device))
        self.Dense_0 = nn.Linear(1792, classes, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.StemV1_0(x)
        for i in range(5):
            x = remat_call(self.remat, getattr(self, f"InceptionResNetA_{i}"), x)
        x = self.ReductionA_0(x)
        for i in range(10):
            x = remat_call(self.remat, getattr(self, f"InceptionResNetB_{i}"), x)
        x = self.ReductionBV1_0(x)
        for i in range(5):
            x = remat_call(self.remat, getattr(self, f"InceptionResNetC_{i}"), x)
        x = dropout(torch.mean(x, dim=(2, 3)), self.dropout_rate, self.training, generator)
        return self.Dense_0(x)
