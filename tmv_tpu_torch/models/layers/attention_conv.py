"""AttentionConv2D and SkipLayer (dormant in the reference).

Port of ``tmv_tpu/models/layers/attention_conv.py`` (the reference's
`layers/attention_conv.py:4-59` and `layers/skip.py:4-26`) on NCHW tensors: a
1 × 1 conv-BN-swish transform ``o`` of the input gated by a spatial attention
map (softmax over the pixels) and a channel attention map (softmax over the
channels), concatenated with the attention-complement of the input, then the
main TF-SAME conv. The two softmaxes stay the unstabilised ``exp / Σ exp`` of
the JAX package. The modules carry flax's names (``conv1``, ``bn1``, ``W1_1``,
``W1_2``, ``V1``, ``W2_1``, ``W2_2``, ``V2``, ``conv2``; SkipLayer's
``layers_i``), which ``convert/flax_bridge.py`` maps. The weights keep torch's
default init; JAX's come through the bridge.
"""

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn

from tmv_tpu_torch.models.layers.common import BatchNorm, conv2d_same, conv_as_input
from tmv_tpu_torch.ops.activations import swish


class AttentionConv2D(nn.Module):
    def __init__(self, in_features: int, filters: int, kernel_size: Union[int, Tuple[int, int]],
                 strides: Union[int, Tuple[int, int]] = 1, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        c = in_features
        kw = dict(dtype=dtype, device=device)
        self.strides = strides
        self.conv1 = nn.Conv2d(c, c, 1, bias=False, **kw)
        self.bn1 = BatchNorm(c, eps=1e-3, momentum=0.01, **kw)
        for name in ("W1_1", "W1_2", "V1", "W2_1", "W2_2", "V2"):
            self.add_module(name, nn.Conv2d(c, c, 1, **kw))
        self.conv2 = nn.Conv2d(2 * c, filters, kernel_size, bias=use_bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = swish(self.bn1(conv_as_input(self.conv1, x)))
        o1 = torch.tanh(conv_as_input(self.W1_1, x) + conv_as_input(self.W1_2, o))
        o1 = conv_as_input(self.V1, o1)
        o1 = torch.exp(o1) / torch.sum(torch.exp(o1), dim=(2, 3), keepdim=True)
        o2 = torch.tanh(conv_as_input(self.W2_1, x) + conv_as_input(self.W2_2, o))
        o2 = conv_as_input(self.V2, o2)
        o2 = torch.exp(o2) / torch.sum(torch.exp(o2), dim=1, keepdim=True)
        merged = torch.cat([o * o1 + o * o2, x * (1.0 - o1) + x * (1.0 - o2)], dim=1)
        bias = None if self.conv2.bias is None else self.conv2.bias.to(x.dtype)
        return conv2d_same(merged, self.conv2.weight.to(x.dtype), bias, self.strides)


class SkipLayer(nn.Module):
    """Run ``layers`` in order and merge with the input: ``concat`` along the
    channels (the default) or ``add``."""

    def __init__(self, layers: Sequence[nn.Module], merge: str = "concat"):
        super().__init__()
        if merge not in ("concat", "add"):
            raise ValueError(merge)
        self.merge = merge
        self.depth = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layers_{i}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.depth):
            y = getattr(self, f"layers_{i}")(y)
        return torch.cat([y, x], dim=1) if self.merge == "concat" else y + x
