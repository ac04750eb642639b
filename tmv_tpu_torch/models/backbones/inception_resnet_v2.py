"""InceptionResNetV2 over the shared Inception modules.

Port of ``tmv_tpu/models/backbones/inception_resnet_v2.py``: the V4 stem, 5 × A
(residual to 384), ReductionA(256, 256, 384, 384), 10 × B (residual to 1152),
ReductionBV2, 5 × C (residual to 2144), then the mean over H and W, dropout and
``Dense(classes)``. Unscaled residual adds followed by relu; flax names
(``InceptionStem_0``, ``InceptionResNetA2_{i}``, …, ``Dense_0``); NCHW in;
``remat`` and the dropout generator as ``inception_resnet_v1.py``.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.models.backbones.inception_modules import (
    Conv2DLinear,
    InceptionStem,
    ReductionA,
    basic_convs,
    max_pool_valid,
)
from tmv_tpu_torch.models.backbones.inception_resnet_v1 import dropout
from tmv_tpu_torch.models.layers.common import remat_call


class InceptionResNetA2(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [(384, 32, 1), (384, 32, 1), (32, 32, 3), (384, 32, 1),
                                    (32, 48, 3), (48, 64, 3)], device)
        self.Conv2DLinear_0 = Conv2DLinear(128, 384, 1, device=device)

    def forward(self, x):
        c = self.c
        y = torch.cat([c[0](x), c[2](c[1](x)), c[5](c[4](c[3](x)))], 1)
        return F.relu(self.Conv2DLinear_0(y) + x)


class InceptionResNetB2(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [(1152, 192, 1), (1152, 128, 1), (128, 160, (1, 7)),
                                    (160, 192, (7, 1))], device)
        self.Conv2DLinear_0 = Conv2DLinear(384, 1152, 1, device=device)

    def forward(self, x):
        c = self.c
        y = torch.cat([c[0](x), c[3](c[2](c[1](x)))], 1)
        return F.relu(self.Conv2DLinear_0(y) + x)


class ReductionBV2(nn.Module):
    """1152 → 2144 channels at half the size."""

    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [
            (1152, 256, 1), (256, 384, 3, 2, "VALID"), (1152, 256, 1), (256, 288, 3, 2, "VALID"),
            (1152, 256, 1), (256, 288, 3), (288, 320, 3, 2, "VALID")], device)

    def forward(self, x):
        c = self.c
        return torch.cat([max_pool_valid(x), c[1](c[0](x)), c[3](c[2](x)),
                          c[6](c[5](c[4](x)))], 1)


class InceptionResNetC2(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.c = basic_convs(self, [(2144, 192, 1), (2144, 192, 1), (192, 224, (1, 3)),
                                    (224, 256, (3, 1))], device)
        self.Conv2DLinear_0 = Conv2DLinear(448, 2144, 1, device=device)

    def forward(self, x):
        c = self.c
        y = torch.cat([c[0](x), c[3](c[2](c[1](x)))], 1)
        return F.relu(self.Conv2DLinear_0(y) + x)


class InceptionResNetV2(nn.Module):
    """NCHW images → ``(B, classes)``; ``generator`` feeds train-mode dropout."""

    def __init__(self, classes: int, dropout_rate: float = 0.2, device=None,
                 remat: bool = False):
        super().__init__()
        self.dropout_rate, self.remat = dropout_rate, remat
        self.InceptionStem_0 = InceptionStem(device)
        for i in range(5):
            self.add_module(f"InceptionResNetA2_{i}", InceptionResNetA2(device))
        self.ReductionA_0 = ReductionA(384, 256, 256, 384, 384, device)
        for i in range(10):
            self.add_module(f"InceptionResNetB2_{i}", InceptionResNetB2(device))
        self.ReductionBV2_0 = ReductionBV2(device)
        for i in range(5):
            self.add_module(f"InceptionResNetC2_{i}", InceptionResNetC2(device))
        self.Dense_0 = nn.Linear(2144, classes, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.InceptionStem_0(x)
        for i in range(5):
            x = remat_call(self.remat, getattr(self, f"InceptionResNetA2_{i}"), x)
        x = self.ReductionA_0(x)
        for i in range(10):
            x = remat_call(self.remat, getattr(self, f"InceptionResNetB2_{i}"), x)
        x = self.ReductionBV2_0(x)
        for i in range(5):
            x = remat_call(self.remat, getattr(self, f"InceptionResNetC2_{i}"), x)
        x = dropout(torch.mean(x, dim=(2, 3)), self.dropout_rate, self.training, generator)
        return self.Dense_0(x)
