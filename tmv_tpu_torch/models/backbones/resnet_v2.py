"""ResNet50V2 (pre-activation) backbone with the three Keras taps.

Port of ``tmv_tpu/models/backbones/resnet_v2.py``: Keras' resnet_v2 stacks and
blocks (pre-activation BatchNorm, the stride in the *last* block of each stack,
a conv shortcut on the first block, a subsampling shortcut on strided blocks),
returning ``conv5_block3_out``, ``conv4_block5_out`` and ``conv3_block3_out``
(strides 32, 16, 8). Submodules carry the flax names: the stem ``conv1``, the
stacks ``conv2``…``conv5``, their blocks ``block1``…``blockN``, and in a block
``BatchNorm_0..2`` and ``Conv_k`` numbered in call order, so that the shortcut
conv, where a block has one, is ``Conv_0``.

Unlike the Darknet models' Keras BatchNorm (epsilon 1e-3), these BatchNorms
have Keras ResNet's epsilon 1.001e-5 (momentum 0.99, torch ``momentum=0.01``).
The stem's 7×7 conv pads 3 and its 3×3 max-pool pads 1 with -inf; the blocks'
3×3 conv pads 1 on each side (not TF-SAME); the strided identity shortcut is
flax's ``max_pool(x, (1, 1), strides=s)``, a subsampling ``x[:, :, ::s, ::s]``.
Inputs are NCHW; weights are cast to the input's type, as ``layers.common``
does. ``remat=True`` runs every block under ``layers.common.remat_call`` in
train mode, as the JAX package wraps ``BlockV2`` in ``nn.remat``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.models.layers.common import (
    BatchNorm, Conv2d, max_pool_padded, remat_call, subsample,
)

BN_EPSILON = 1.001e-5


def _bn(features: int, device=None) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPSILON, momentum=0.01, device=device)


class BlockV2(nn.Module):
    def __init__(self, in_features: int, filters: int, stride: int = 1,
                 conv_shortcut: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stride, self.conv_shortcut = stride, conv_shortcut
        self.BatchNorm_0 = _bn(in_features, device)
        convs = [Conv2d(in_features, 4 * filters, 1, stride, **kw)] if conv_shortcut else []
        convs += [Conv2d(in_features, filters, 1, bias=False, **kw),
                  Conv2d(filters, filters, 3, stride, padding=1, bias=False, **kw),
                  Conv2d(filters, 4 * filters, 1, **kw)]
        for k, conv in enumerate(convs):
            self.add_module(f"Conv_{k}", conv)
        self.BatchNorm_1 = _bn(filters, device)
        self.BatchNorm_2 = _bn(filters, device)

    def forward(self, x):
        preact = F.relu(self.BatchNorm_0(x))
        k = 0
        if self.conv_shortcut:
            shortcut, k = self.Conv_0(preact), 1
        elif self.stride > 1:
            shortcut = subsample(x, self.stride)
        else:
            shortcut = x
        y = F.relu(self.BatchNorm_1(getattr(self, f"Conv_{k}")(preact)))
        y = F.relu(self.BatchNorm_2(getattr(self, f"Conv_{k + 1}")(y)))
        return shortcut + getattr(self, f"Conv_{k + 2}")(y)


class StackV2(nn.Module):
    """``blocks`` blocks of ``filters``; ``forward(x, tap_block)`` → (out, the
    output of block ``tap_block`` or None)."""

    def __init__(self, in_features: int, filters: int, blocks: int, stride1: int = 2,
                 dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.blocks, self.remat = blocks, remat
        self.block1 = BlockV2(in_features, filters, conv_shortcut=True, **kw)
        for i in range(2, blocks):
            self.add_module(f"block{i}", BlockV2(4 * filters, filters, **kw))
        self.add_module(f"block{blocks}", BlockV2(4 * filters, filters, stride=stride1, **kw))

    def forward(self, x, tap_block=None):
        tap = None
        for i in range(1, self.blocks + 1):
            x = remat_call(self.remat, getattr(self, f"block{i}"), x)
            if tap_block == i:
                tap = x
        return x, tap


class ResNet50V2(nn.Module):
    """Feature extractor: NCHW → (conv5_block3_out, conv4_block5_out,
    conv3_block3_out) at strides (32, 16, 8), 2048/1024/512 channels."""

    def __init__(self, dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        stack = dict(kw, remat=remat)
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, **kw)
        self.conv2 = StackV2(64, 64, 3, **stack)
        self.conv3 = StackV2(256, 128, 4, **stack)
        self.conv4 = StackV2(512, 256, 6, **stack)
        self.conv5 = StackV2(1024, 512, 3, stride1=1, **stack)

    def forward(self, x):
        x = max_pool_padded(self.conv1(x), 3, 2, 1)
        x, _ = self.conv2(x)
        x, y3 = self.conv3(x, tap_block=3)
        x, y2 = self.conv4(x, tap_block=5)
        _, y1 = self.conv5(x, tap_block=3)
        return y1, y2, y3
