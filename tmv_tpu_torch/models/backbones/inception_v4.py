"""InceptionV4.

Port of ``tmv_tpu/models/backbones/inception_v4.py``: the stem, 4 × A,
ReductionA(192, 224, 256, 384), 7 × B, ReductionBV4, 3 × C, then the mean over H
and W, dropout and ``Dense(classes)``. Flax names (``InceptionStem_0``,
``InceptionBlockA_{i}``, …, ``Dense_0``); NCHW in; ``remat`` and the dropout
generator as ``inception_resnet_v1.py``.
"""

from typing import Optional

import torch
import torch.nn as nn

from tmv_tpu_torch.models.backbones.inception_modules import (
    InceptionBlockA,
    InceptionBlockB,
    InceptionBlockC,
    InceptionStem,
    ReductionA,
    ReductionBV4,
)
from tmv_tpu_torch.models.backbones.inception_resnet_v1 import dropout
from tmv_tpu_torch.models.layers.common import remat_call

class InceptionV4(nn.Module):
    """NCHW images → ``(B, classes)``; ``generator`` feeds train-mode dropout."""

    def __init__(self, classes: int, dropout_rate: float = 0.2, device=None,
                 remat: bool = False):
        super().__init__()
        self.dropout_rate, self.remat = dropout_rate, remat
        self.InceptionStem_0 = InceptionStem(device)
        for i in range(4):
            self.add_module(f"InceptionBlockA_{i}", InceptionBlockA(384, device))
        self.ReductionA_0 = ReductionA(384, 192, 224, 256, 384, device)
        for i in range(7):
            self.add_module(f"InceptionBlockB_{i}", InceptionBlockB(1024, device))
        self.ReductionBV4_0 = ReductionBV4(1024, device)
        for i in range(3):
            self.add_module(f"InceptionBlockC_{i}", InceptionBlockC(1536, device))
        self.Dense_0 = nn.Linear(1536, classes, device=device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.InceptionStem_0(x)
        for i in range(4):
            x = remat_call(self.remat, getattr(self, f"InceptionBlockA_{i}"), x)
        x = self.ReductionA_0(x)
        for i in range(7):
            x = remat_call(self.remat, getattr(self, f"InceptionBlockB_{i}"), x)
        x = self.ReductionBV4_0(x)
        for i in range(3):
            x = remat_call(self.remat, getattr(self, f"InceptionBlockC_{i}"), x)
        x = dropout(torch.mean(x, dim=(2, 3)), self.dropout_rate, self.training, generator)
        return self.Dense_0(x)
