"""The ResNetV2-YOLO tower of the MoCo and distillation families.

Port of ``tmv_tpu/models/moco.py::ResNetYoloV3`` only: the ResNet50V2 taps
under YOLOv3's neck and heads. The MoCo queue, the momentum update and the
InfoNCE loss are not ported.
"""

from typing import Tuple

import torch
import torch.nn as nn

from tmv_tpu_torch.models.backbones.resnet_v2 import ResNet50V2
from tmv_tpu_torch.models.yolo_v3 import add_heads, heads_forward


class ResNetYoloV3(nn.Module):
    """ResNet50V2 backbone + YOLOv3 neck/heads: NHWC image → (h1, h2, h3) NHWC
    raw heads of ``out_filters`` channels at strides 32/16/8. ``dtype`` and
    ``param_dtype`` are those of ``yolo_v4.YoloV4``; ``remat`` runs ResNet50V2's
    blocks and the three ``LastLayers`` under ``layers.common.remat_call``."""

    def __init__(self, out_filters: int, dtype: torch.dtype = torch.float32, device=None,
                 param_dtype=None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=param_dtype or dtype, device=device)
        self.ResNet50V2_0 = ResNet50V2(remat=remat, **kw)
        add_heads(self, (2048, 1024, 512), out_filters, **kw)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return heads_forward(self, *self.ResNet50V2_0(x), remat=self.remat)
