"""YOLOv4: CSPDarknet-53 + SPP + PANet, Mish backbone.

Port of ``tmv_tpu/models/yolo_v4.py`` at full width (filters 32…1024, block
counts 1/2/8/8/4). Submodules carry the flax auto-names (``ConvBN_0``,
``BlocksLayer2_1``, ``DarknetConv_0``, …; a module's k-th child of one class is
``<Class>_k`` in call order), so that a flax variable tree maps onto the
``state_dict`` path by path. The stages take and return NCHW tensors; ``YoloV4``
itself takes NHWC images and returns NHWC heads, the JAX package's layout, and
runs NCHW in ``channels_last`` memory inside (the permutes are views). ``dtype``
is the compute type; ``param_dtype`` (default: ``dtype``) the type the conv
weights are held in. Serving holds bf16 weights; training with bf16 activations
holds float32 weights (``param_dtype=torch.float32``), as flax does. In train
mode the BatchNorms use and update batch statistics (``layers.common.BatchNorm``).
``remat=True`` runs every stage (``BlocksLayer``, ``BlocksLayer2``, ``LastLayer``,
``LastLayer2``, ``OutputLayer2``), the modules the JAX package wraps in
``nn.remat``, under ``layers.common.remat_call`` in train mode; the
``state_dict`` is the same with and without it.
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.models.layers.common import (
    ConvBN, DarknetConv, max_pool_same, remat_call, upsample2x,
)

# COCO anchors in pixels, coarsest (stride-32) scale first, as
# ``tmv_tpu.data.loaders.load_anchors`` orders them.
COCO_ANCHORS = np.array(
    [[[116, 90], [156, 198], [373, 326]],
     [[30, 61], [62, 45], [59, 119]],
     [[10, 13], [16, 30], [33, 23]]], np.float32)


def _conv_chain(module: nn.Module, first: int, x: torch.Tensor, count: int) -> torch.Tensor:
    """Apply ``ConvBN_first`` … ``ConvBN_{first+count-1}`` in order."""
    for k in range(first, first + count):
        x = getattr(module, f"ConvBN_{k}")(x)
    return x


class BlocksLayer(nn.Module):
    """First CSP stage (full-width branches)."""

    def __init__(self, in_features: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        f, kw = filters, dict(act="mish", dtype=dtype, device=device)
        self.ConvBN_0 = ConvBN(in_features, f, 3, strides=2, **kw)
        self.ConvBN_1 = ConvBN(f, f, 1, **kw)
        self.ConvBN_2 = ConvBN(f, f, 1, **kw)
        self.ConvBN_3 = ConvBN(f, f // 2, 1, **kw)
        self.ConvBN_4 = ConvBN(f // 2, f, 3, **kw)
        self.ConvBN_5 = ConvBN(f, f, 1, **kw)
        self.ConvBN_6 = ConvBN(2 * f, f, 1, **kw)

    def forward(self, x):
        x = self.ConvBN_0(x)
        x1 = self.ConvBN_1(x)
        x2_1 = self.ConvBN_2(x)
        x2_2 = self.ConvBN_4(self.ConvBN_3(x2_1))
        x2 = self.ConvBN_5(x2_1 + x2_2)
        return self.ConvBN_6(torch.cat([x2, x1], dim=1))


class BlocksLayer2(nn.Module):
    """CSP stage with half-width branches and ``blocks_num`` residual blocks."""

    def __init__(self, in_features: int, filters: int, blocks_num: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        f, h, kw = filters, filters // 2, dict(act="mish", dtype=dtype, device=device)
        self.blocks_num = blocks_num
        self.ConvBN_0 = ConvBN(in_features, f, 3, strides=2, **kw)
        self.ConvBN_1 = ConvBN(f, h, 1, **kw)
        self.ConvBN_2 = ConvBN(f, h, 1, **kw)
        for k in range(blocks_num):
            self.add_module(f"ConvBN_{3 + 2 * k}", ConvBN(h, h, 1, **kw))
            self.add_module(f"ConvBN_{4 + 2 * k}", ConvBN(h, h, 3, **kw))
        self.add_module(f"ConvBN_{3 + 2 * blocks_num}", ConvBN(h, h, 1, **kw))
        self.add_module(f"ConvBN_{4 + 2 * blocks_num}", ConvBN(f, f, 1, **kw))

    def forward(self, x):
        x = self.ConvBN_0(x)
        x1 = self.ConvBN_1(x)
        x2_1 = self.ConvBN_2(x)
        for k in range(self.blocks_num):
            x2_1 = x2_1 + _conv_chain(self, 3 + 2 * k, x2_1, 2)
        x2 = _conv_chain(self, 3 + 2 * self.blocks_num, x2_1, 1)
        return _conv_chain(self, 4 + 2 * self.blocks_num, torch.cat([x2, x1], dim=1), 1)


class LastLayer(nn.Module):
    """3conv + SPP (maxpool 5/9/13, concat reversed) + 3conv neck, Leaky."""

    def __init__(self, in_features: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        f, kw = filters, dict(act="leaky", dtype=dtype, device=device)
        self.ConvBN_0 = ConvBN(in_features, f, 1, **kw)
        self.ConvBN_1 = ConvBN(f, 2 * f, 3, **kw)
        self.ConvBN_2 = ConvBN(2 * f, f, 1, **kw)
        self.ConvBN_3 = ConvBN(4 * f, f, 1, **kw)
        self.ConvBN_4 = ConvBN(f, 2 * f, 3, **kw)
        self.ConvBN_5 = ConvBN(2 * f, f, 1, **kw)

    def forward(self, x):
        x = _conv_chain(self, 0, x, 3)
        x = torch.cat([max_pool_same(x, 13), max_pool_same(x, 9), max_pool_same(x, 5), x], dim=1)
        return _conv_chain(self, 3, x, 3)


class LastLayer2(nn.Module):
    """PAN top-down merge: upsample the coarse map, concat, 5 convs."""

    def __init__(self, in1: int, in2: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        f, kw = filters, dict(act="leaky", dtype=dtype, device=device)
        self.ConvBN_0 = ConvBN(in1, f, 1, **kw)
        self.ConvBN_1 = ConvBN(in2, f, 1, **kw)
        self.ConvBN_2 = ConvBN(2 * f, f, 1, **kw)
        self.ConvBN_3 = ConvBN(f, 2 * f, 3, **kw)
        self.ConvBN_4 = ConvBN(2 * f, f, 1, **kw)
        self.ConvBN_5 = ConvBN(f, 2 * f, 3, **kw)
        self.ConvBN_6 = ConvBN(2 * f, f, 1, **kw)

    def forward(self, x1, x2):
        x1 = upsample2x(self.ConvBN_0(x1))
        x2 = self.ConvBN_1(x2)
        return _conv_chain(self, 2, torch.cat([x2, x1], dim=1), 5)


class OutputLayer2(nn.Module):
    """PAN bottom-up merge + pre-head conv; returns (head input, merged map)."""

    def __init__(self, in_x: int, in_y: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        f, kw = filters, dict(act="leaky", dtype=dtype, device=device)
        self.ConvBN_0 = ConvBN(in_x, f, 3, strides=2, **kw)
        self.ConvBN_1 = ConvBN(f + in_y, f, 1, **kw)
        self.ConvBN_2 = ConvBN(f, 2 * f, 3, **kw)
        self.ConvBN_3 = ConvBN(2 * f, f, 1, **kw)
        self.ConvBN_4 = ConvBN(f, 2 * f, 3, **kw)
        self.ConvBN_5 = ConvBN(2 * f, f, 1, **kw)
        self.ConvBN_6 = ConvBN(f, 2 * f, 3, **kw)

    def forward(self, x, y):
        x = torch.cat([self.ConvBN_0(x), y], dim=1)
        x = _conv_chain(self, 1, x, 5)
        return self.ConvBN_6(x), x


class YoloV4(nn.Module):
    """Forward network: NHWC image → (z1, z2, z3) NHWC raw heads (strides 32/16/8)."""

    def __init__(self, classes_num: int, anchors_num: int = 3,
                 dtype: torch.dtype = torch.float32, device=None, param_dtype=None,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=param_dtype or dtype, device=device)
        out_filters = anchors_num * (5 + classes_num)
        self.ConvBN_0 = ConvBN(3, 32, 3, act="mish", **kw)
        self.BlocksLayer_0 = BlocksLayer(32, 64, **kw)
        self.BlocksLayer2_0 = BlocksLayer2(64, 128, 2, **kw)
        self.BlocksLayer2_1 = BlocksLayer2(128, 256, 8, **kw)
        self.BlocksLayer2_2 = BlocksLayer2(256, 512, 8, **kw)
        self.BlocksLayer2_3 = BlocksLayer2(512, 1024, 4, **kw)
        self.LastLayer_0 = LastLayer(1024, 512, **kw)
        self.LastLayer2_0 = LastLayer2(512, 512, 256, **kw)
        self.LastLayer2_1 = LastLayer2(256, 256, 128, **kw)
        self.ConvBN_1 = ConvBN(128, 256, 3, act="leaky", **kw)
        self.DarknetConv_0 = DarknetConv(256, out_filters, 1, **kw)
        self.OutputLayer2_0 = OutputLayer2(128, 256, 256, **kw)
        self.DarknetConv_1 = DarknetConv(512, out_filters, 1, **kw)
        self.OutputLayer2_1 = OutputLayer2(256, 512, 512, **kw)
        self.DarknetConv_2 = DarknetConv(1024, out_filters, 1, **kw)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        def stage(module, *args):
            return remat_call(self.remat, module, *args)

        x = self.ConvBN_0(x)
        x = stage(self.BlocksLayer_0, x)
        x = stage(self.BlocksLayer2_0, x)
        y3 = x = stage(self.BlocksLayer2_1, x)
        y2 = x = stage(self.BlocksLayer2_2, x)
        y1 = stage(self.BlocksLayer2_3, x)

        y1 = stage(self.LastLayer_0, y1)
        y2 = stage(self.LastLayer2_0, y1, y2)
        y3 = stage(self.LastLayer2_1, y2, y3)

        z3 = self.DarknetConv_0(self.ConvBN_1(y3))       # stride 8
        z2, y2 = stage(self.OutputLayer2_0, y3, y2)
        z2 = self.DarknetConv_1(z2)                      # stride 16
        z1, _ = stage(self.OutputLayer2_1, y2, y1)
        z1 = self.DarknetConv_2(z1)                      # stride 32
        return tuple(z.permute(0, 2, 3, 1) for z in (z1, z2, z3))
