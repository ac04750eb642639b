"""YOLOv3: Darknet-53 backbone + FPN-style 3-scale head.

Port of ``tmv_tpu/models/yolo_v3.py`` at full width (stem 32, stages
64/1, 128/2, 256/8, 512/8, 1024/4). Submodules carry the flax auto-names
(``DarknetBody_0``, ``ResblockBody_k``, ``LastLayers_k``, ``ConvBN_k``,
``DarknetConv_k``, in the JAX package's call order), so that a flax variable
tree maps onto the ``state_dict`` path by path. ``YoloV3`` takes NHWC images and
returns NHWC heads ``(B, h, w, A·(5+C))`` at strides 32/16/8; inside it runs
NCHW in ``channels_last`` memory. ``dtype`` and ``param_dtype`` are those of
``yolo_v4.YoloV4``. ``remat=True`` runs each ``ResblockBody`` and ``LastLayers``
under ``layers.common.remat_call`` in train mode, as the JAX package wraps them
in ``nn.remat``.
"""

from typing import Tuple

import torch
import torch.nn as nn

from tmv_tpu_torch.models.layers.common import ConvBN, DarknetConv, remat_call, upsample2x


class ResblockBody(nn.Module):
    """Top-left-padded stride-2 3×3 conv, then ``num_blocks`` × (1×1 half → 3×3
    full) residual adds."""

    def __init__(self, in_features: int, num_filters: int, num_blocks: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        f, kw = num_filters, dict(act="leaky", dtype=dtype, device=device)
        self.num_blocks = num_blocks
        self.ConvBN_0 = ConvBN(in_features, f, 3, strides=2, **kw)
        for k in range(num_blocks):
            self.add_module(f"ConvBN_{1 + 2 * k}", ConvBN(f, f // 2, 1, **kw))
            self.add_module(f"ConvBN_{2 + 2 * k}", ConvBN(f // 2, f, 3, **kw))

    def forward(self, x):
        x = self.ConvBN_0(x)
        for k in range(self.num_blocks):
            y = getattr(self, f"ConvBN_{1 + 2 * k}")(x)
            x = x + getattr(self, f"ConvBN_{2 + 2 * k}")(y)
        return x


class DarknetBody(nn.Module):
    """Darknet-53: 32-filter stem, five residual stages; returns the taps after
    stages 5, 4 and 3 (strides 32, 16, 8)."""

    def __init__(self, dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.remat = remat
        self.ConvBN_0 = ConvBN(3, 32, 3, act="leaky", **kw)
        self.ResblockBody_0 = ResblockBody(32, 64, 1, **kw)
        self.ResblockBody_1 = ResblockBody(64, 128, 2, **kw)
        self.ResblockBody_2 = ResblockBody(128, 256, 8, **kw)
        self.ResblockBody_3 = ResblockBody(256, 512, 8, **kw)
        self.ResblockBody_4 = ResblockBody(512, 1024, 4, **kw)

    def forward(self, x):
        def stage(module, x):
            return remat_call(self.remat, module, x)

        x = self.ConvBN_0(x)
        x = stage(self.ResblockBody_1, stage(self.ResblockBody_0, x))
        y3 = x = stage(self.ResblockBody_2, x)
        y2 = x = stage(self.ResblockBody_3, x)
        return stage(self.ResblockBody_4, x), y2, y3


class LastLayers(nn.Module):
    """Alternating 1×1/3×3 convs; returns the 5-conv tap (top-down path) and the
    6-conv output (head input)."""

    def __init__(self, in_features: int, num_filters: int, dtype=torch.float32, device=None):
        super().__init__()
        f, kw = num_filters, dict(act="leaky", dtype=dtype, device=device)
        for k in range(6):
            cin = in_features if k == 0 else (f if k % 2 else 2 * f)
            self.add_module(f"ConvBN_{k}", ConvBN(cin, 2 * f if k % 2 else f, 1 + 2 * (k % 2),
                                                  **kw))

    def forward(self, x):
        for k in range(5):
            x = getattr(self, f"ConvBN_{k}")(x)
        return x, self.ConvBN_5(x)


def add_heads(model: nn.Module, taps: Tuple[int, int, int], out_filters: int,
              dtype=torch.float32, device=None):
    """Register the YOLOv3 neck and heads on ``model`` over taps of ``taps``
    channels (strides 32/16/8), under the flax names: ``LastLayers_k`` per
    scale, the upsampling ``ConvBN_k`` and a bias-full 1×1 ``DarknetConv_k``
    output conv per scale, in the JAX package's call order. Shared by
    ``YoloV3`` and ``moco.ResNetYoloV3``."""
    c1, c2, c3 = taps
    kw = dict(dtype=dtype, device=device)
    model.LastLayers_0 = LastLayers(c1, 512, **kw)
    model.DarknetConv_0 = DarknetConv(1024, out_filters, 1, **kw)
    model.ConvBN_0 = ConvBN(512, 256, 1, act="leaky", **kw)
    model.LastLayers_1 = LastLayers(256 + c2, 256, **kw)
    model.DarknetConv_1 = DarknetConv(512, out_filters, 1, **kw)
    model.ConvBN_1 = ConvBN(256, 128, 1, act="leaky", **kw)
    model.LastLayers_2 = LastLayers(128 + c3, 128, **kw)
    model.DarknetConv_2 = DarknetConv(256, out_filters, 1, **kw)


def heads_forward(model: nn.Module, y1, y2, y3, remat: bool = False):
    """The neck and heads of ``add_heads`` on NCHW taps → NHWC raw heads; with
    ``remat`` each ``LastLayers`` runs under ``remat_call``."""
    x, h1 = remat_call(remat, model.LastLayers_0, y1)
    h1 = model.DarknetConv_0(h1)
    x = torch.cat([upsample2x(model.ConvBN_0(x)), y2], dim=1)
    x, h2 = remat_call(remat, model.LastLayers_1, x)
    h2 = model.DarknetConv_1(h2)
    x = torch.cat([upsample2x(model.ConvBN_1(x)), y3], dim=1)
    _, h3 = remat_call(remat, model.LastLayers_2, x)
    h3 = model.DarknetConv_2(h3)
    return tuple(h.permute(0, 2, 3, 1) for h in (h1, h2, h3))


class YoloV3(nn.Module):
    """Forward network: NHWC image → (h1, h2, h3) NHWC raw heads (13², 26², 52²
    at 416 input)."""

    def __init__(self, classes_num: int, anchors_num: int = 3,
                 dtype: torch.dtype = torch.float32, device=None, param_dtype=None,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=param_dtype or dtype, device=device)
        self.DarknetBody_0 = DarknetBody(remat=remat, **kw)
        add_heads(self, (1024, 512, 256), anchors_num * (classes_num + 5), **kw)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return heads_forward(self, *self.DarknetBody_0(x), remat=self.remat)
