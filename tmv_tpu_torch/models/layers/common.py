"""Shared conv building blocks (NCHW inside, ``channels_last`` memory).

Port of ``tmv_tpu/models/layers/common.py`` in float only (its int8 and
calibration branches are not ported). Submodules carry the flax auto-names
(``DarknetConv_0/Conv_0``, ``BatchNorm_0``) so that ``convert.flax_bridge`` maps
a flax tree onto them by path.

- Darknet stride-2 convs pad top-left ``((1, 0), (1, 0))`` and run VALID.
- Every other conv pads TF-SAME explicitly (torch's ``padding='same'`` refuses
  stride 2); the SPP max-pool pads SAME with -inf.
- BatchNorm is Keras's: epsilon 1e-3, momentum 0.99 (torch ``momentum=0.01``).
- ``dtype`` is the compute type. Conv weights are held in it, BatchNorm
  parameters and statistics stay float32, as in the JAX package's policy.
"""

import math
from typing import Callable, Dict, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.ops.activations import leaky_relu, mish, swish

ACTIVATIONS: Dict[str, Callable] = {"leaky": leaky_relu, "mish": mish, "swish": swish}


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride: Union[int, Tuple[int, int]] = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with TF-SAME padding; an asymmetric pad is applied explicitly."""
    stride = _pair(stride)
    (top, bottom), (left, right) = (same_pads(x.shape[2], weight.shape[2], stride[0]),
                                    same_pads(x.shape[3], weight.shape[3], stride[1]))
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride, groups=groups)


class DarknetConv(nn.Module):
    """Conv2D with Darknet padding semantics (no BN, optional bias)."""

    def __init__(self, in_features: int, filters: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.Conv_0 = nn.Conv2d(in_features, filters, self.kernel_size, self.strides,
                                bias=use_bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        if self.strides == (2, 2):
            # Darknet downsampling: top-left zero pad + VALID
            return F.conv2d(F.pad(x, (1, 0, 1, 0)), conv.weight, conv.bias, self.strides)
        return conv2d_same(x, conv.weight, conv.bias, self.strides)


class ConvBN(nn.Module):
    """Conv → BatchNorm → activation (DarknetConv2D_BN_{Leaky,Mish} parity)."""

    def __init__(self, in_features: int, filters: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1, act: str = "leaky",
                 dtype: torch.dtype = torch.float32, device=None,
                 bn_momentum: float = 0.99, bn_epsilon: float = 1e-3):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.DarknetConv_0 = DarknetConv(in_features, filters, kernel_size, strides,
                                         use_bias=False, dtype=dtype, device=device)
        self.BatchNorm_0 = nn.BatchNorm2d(filters, eps=bn_epsilon,
                                          momentum=1.0 - bn_momentum, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.BatchNorm_0(self.DarknetConv_0(x)))


def max_pool_same(x: torch.Tensor, window: int, strides: int = 1) -> torch.Tensor:
    """MaxPool2D with SAME padding (SPP pools), padded with -inf."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], window, strides),
                                    same_pads(x.shape[3], window, strides))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """UpSampling2D(2), nearest."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init as the JAX package's: He-uniform conv kernels, zero biases,
    identity BatchNorm. Values are drawn on the CPU from one ``torch.Generator``
    in module order, so a seed gives the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            limit = math.sqrt(6.0 / fan_in)
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            m.weight.copy_(w.uniform_(-limit, limit, generator=gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
