"""BiFPN: resample layers, weighted-fusion nodes and the N-level cell.

Port of ``tmv_tpu/models/efficientdet/bifpn.py``. Submodules and parameters
carry the flax names (``ResampleFeatureMap_i/{conv2d,bn}``,
``OpAfterCombine_0/{SeparableConv_0/{depthwise,pointwise},BatchNorm_0}``,
``BiFPNNode_j/WSM_i``) so that ``convert.flax_bridge`` maps a flax tree onto them.

- ``SeparableConv``: depthwise 3×3 then 1×1 with bias, on stock torch convs
  (these depthwise convs were outside any Pallas kernel in the JAX package too).
  In eval mode under ``quant.quantized("int8_static")`` both run as the static int8
  sites ``depthwise`` and ``pointwise`` (``kernels.int8_conv``; the depthwise's
  float32 output goes into the pointwise uncast, then one cast to the input's
  type); ``quantize=False`` pins a SeparableConv to float (the head ``predict``).
  Under ``"calib"`` both sites record their inputs' ranges.
- ``ResampleFeatureMap``: 1×1 conv + BatchNorm iff the channels differ, then a
  3×3 stride-2 SAME max-pool if taller than the target (padded explicitly with
  -inf, asymmetrically where SAME says so) or a nearest resize if shorter.
  ``jax.image.resize(..., "nearest")`` samples at half-pixel centres, which is
  ``F.interpolate(mode="nearest-exact")``; plain ``"nearest"`` differs on ratios
  other than 2.
- ``BiFPNNode``: the five weight methods — ``fastattn`` (raw scalars, no relu,
  ``Σ wᵢ·xᵢ / (Σw + 1e-4)``), ``sum``, ``attn`` (softmax of scalars),
  ``channel_attn`` (per-channel softmax) and ``channel_fastattn`` — then swish →
  SeparableConv → BatchNorm (``OpAfterCombine``).
- ``BiFPN``: the top-down then bottom-up graph over any number (≥ 3) of levels;
  at five levels the reference's P3–P7 8-node cell.
"""

from typing import List, Sequence

import torch
import torch.nn as nn

from tmv_tpu_torch.models.efficientdet.backbone import batch_norm
from tmv_tpu_torch.models.layers.common import (
    as_dtype, conv2d_same, conv_as_input, max_pool_same,
)
from tmv_tpu_torch.ops.activations import swish
from tmv_tpu_torch.parallel import halo
from tmv_tpu_torch.quant.dynamic import quant_mode
from tmv_tpu_torch.quant.static import record, static_conv_site

WEIGHT_METHODS = ("fastattn", "sum", "attn", "channel_attn", "channel_fastattn")


class SeparableConv(nn.Module):
    """SeparableConv2D(depth_multiplier=1): depthwise k×k then 1×1."""

    def __init__(self, in_features: int, filters: int, kernel_size: int = 3,
                 use_bias: bool = True, dtype=torch.float32, device=None, quantize: bool = True):
        super().__init__()
        self.quantize = quantize
        kw = dict(dtype=dtype, device=device)
        self.depthwise = nn.Conv2d(in_features, in_features, kernel_size, groups=in_features,
                                   bias=False, **kw)
        self.pointwise = nn.Conv2d(in_features, filters, 1, bias=use_bias, **kw)

    def forward(self, x):
        mode = quant_mode() if self.quantize else "off"
        if mode == "int8_static" and not self.training:
            y = static_conv_site(self, "_depthwise", x, self.depthwise.kernel_size)
            return static_conv_site(self, "_pointwise", y, (1, 1), out_dtype=x.dtype)
        if mode == "calib":
            record(self, "in_absmax_depthwise", x)
        x = conv2d_same(x, as_dtype(self.depthwise.weight, x.dtype), None, 1,
                        groups=self.depthwise.groups)
        if mode == "calib":
            record(self, "in_absmax_pointwise", x)
        return conv_as_input(self.pointwise, x)


class ResampleFeatureMap(nn.Module):
    def __init__(self, in_channels: int, target_num_channels: int, level_size: int,
                 bn_momentum: float = 0.99, bn_epsilon: float = 1e-3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.level_size = level_size
        self.project = in_channels != target_num_channels
        if self.project:
            self.conv2d = nn.Conv2d(in_channels, target_num_channels, 1, dtype=dtype,
                                    device=device)
            self.bn = batch_norm(target_num_channels, bn_momentum, bn_epsilon, device)

    def forward(self, x):
        h = halo.global_height(x)
        if self.project:
            x = self.bn(conv_as_input(self.conv2d, x))
        if h > self.level_size:
            x = max_pool_same(x, 3, 2)
        elif h < self.level_size:
            x = halo.resize_rows(x, self.level_size)
        return x


class OpAfterCombine(nn.Module):
    def __init__(self, filters: int, bn_momentum: float = 0.99, bn_epsilon: float = 1e-3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.SeparableConv_0 = SeparableConv(filters, filters, 3, True, dtype, device)
        self.BatchNorm_0 = batch_norm(filters, bn_momentum, bn_epsilon, device)

    def forward(self, x):
        return self.BatchNorm_0(self.SeparableConv_0(swish(x)))


class BiFPNNode(nn.Module):
    def __init__(self, filters: int, level_size: int, in_channels: Sequence[int],
                 weight_method: str = "fastattn", bn_momentum: float = 0.99,
                 bn_epsilon: float = 1e-3, dtype=torch.float32, device=None):
        super().__init__()
        if weight_method not in WEIGHT_METHODS:
            raise ValueError(f"unknown BiFPN weight method {weight_method!r}")
        self.weight_method = weight_method
        self.num_inputs = len(in_channels)
        for i, ch in enumerate(in_channels):
            self.add_module(f"ResampleFeatureMap_{i}", ResampleFeatureMap(
                ch, filters, level_size, bn_momentum, bn_epsilon, dtype, device))
        if weight_method != "sum":
            shape = (filters,) if weight_method.startswith("channel") else ()
            for i in range(self.num_inputs):
                self.register_parameter(
                    f"WSM_{i}", nn.Parameter(torch.ones(shape, device=device)))
        self.OpAfterCombine_0 = OpAfterCombine(filters, bn_momentum, bn_epsilon, dtype, device)

    def _weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"WSM_{i}") for i in range(self.num_inputs)]

    def forward(self, inputs: Sequence[torch.Tensor]):
        assert len(inputs) == self.num_inputs
        resampled = [getattr(self, f"ResampleFeatureMap_{i}")(x) for i, x in enumerate(inputs)]
        dtype = resampled[0].dtype
        method = self.weight_method
        if method == "sum":
            fused = sum(resampled)
        elif method == "attn":
            norm = torch.softmax(torch.stack(self._weights()).to(dtype), dim=0)
            fused = sum(r * norm[i] for i, r in enumerate(resampled))
        elif method == "channel_attn":
            norm = torch.softmax(torch.stack(self._weights(), dim=-1).to(dtype), dim=-1)
            fused = sum(r * norm[:, i].view(1, -1, 1, 1) for i, r in enumerate(resampled))
        elif method == "channel_fastattn":
            wsms = [w.to(dtype).view(1, -1, 1, 1) for w in self._weights()]
            wsum = sum(wsms)
            fused = sum(r * w / (wsum + 1e-4) for r, w in zip(resampled, wsms))
        else:  # raw-scalar fast attention
            wsms = self._weights()
            wsum = sum(wsms)
            fused = sum(r * w / (wsum + 1e-4) for r, w in zip(resampled, wsms))
        return self.OpAfterCombine_0(fused)


class BiFPN(nn.Module):
    """One BiFPN cell: top-down then bottom-up weighted-fusion nodes over
    ``len(levels_size)`` levels whose inputs have ``in_channels``."""

    def __init__(self, filters: int, levels_size: Sequence[int], in_channels: Sequence[int],
                 weight_method: str = "fastattn", bn_momentum: float = 0.99,
                 bn_epsilon: float = 1e-3, dtype=torch.float32, device=None):
        super().__init__()
        n = len(levels_size)
        assert n == len(in_channels) and n >= 3
        ls, ch = list(levels_size), list(in_channels)
        nodes = []
        # top-down: td[i] for i = n-2 … 1
        for i in range(n - 2, 0, -1):
            nodes.append((ls[i], [ch[i], ch[n - 1] if i == n - 2 else filters]))
        # bottom-up outputs
        nodes.append((ls[0], [ch[0], filters]))
        for i in range(1, n - 1):
            nodes.append((ls[i], [ch[i], filters, filters]))
        nodes.append((ls[n - 1], [ch[n - 1], filters]))
        for j, (size, node_in) in enumerate(nodes):
            self.add_module(f"BiFPNNode_{j}", BiFPNNode(
                filters, size, node_in, weight_method, bn_momentum, bn_epsilon, dtype, device))
        self.num_levels = n

    def forward(self, inputs: Sequence[torch.Tensor]):
        n = self.num_levels
        nodes = iter(getattr(self, f"BiFPNNode_{j}") for j in range(2 * n - 2))
        td = {}
        prev = inputs[n - 1]
        for i in range(n - 2, 0, -1):
            td[i] = next(nodes)([inputs[i], prev])
            prev = td[i]
        outs = [next(nodes)([inputs[0], td[1]])]
        for i in range(1, n - 1):
            outs.append(next(nodes)([inputs[i], td[i], outs[-1]]))
        outs.append(next(nodes)([inputs[n - 1], outs[-1]]))
        return tuple(outs)
