"""EfficientNet backbone: Stem + MBConv chain with reduction endpoints.

Port of ``tmv_tpu/models/efficientdet/backbone.py``, with its int8 and calibration
sites and the opt-in space-to-depth stem (``stem_s2d``). Submodules carry the
flax names (``Stem_0``, ``MBConvBlock_k/Conv_i``, ``BatchNorm_i``, ``SE_0``) so
that ``convert.flax_bridge`` maps a flax tree onto them by path.

- ``MBConvBlock``: 1×1 expand (skipped at expand_ratio 1) → depthwise k×k → SE
  → 1×1 project, BatchNorm after each conv. Like the reference, the block has
  **no residual skip**: it returns the projection.
- In eval, the depthwise + BatchNorm + swish of every block is one call of
  ``kernels.dwconv.fused_dw_bn_swish``: the CUDA kernel on a CUDA tensor, the
  plain version on a CPU tensor. The BatchNorm is folded in float32 into
  ``scale = γ / sqrt(var + eps)`` and ``offset = β − mean · scale``. In train
  mode the block runs conv → BatchNorm (batch statistics) → swish in plain torch.
- TF-SAME padding; stride 2 pads asymmetrically, explicitly.
- ``dtype`` is the type the 1×1 and stem conv weights are held in; each conv
  casts its weight to its input's type (``layers.common.conv_as_input``), so a
  float32 model fed bf16 activations trains on float32 master weights. The
  depthwise taps and BatchNorm parameters and statistics are float32 (the
  kernel takes float32 taps, as the Pallas kernel did).
- The BatchNorms are ``layers.common.BatchNorm``: in train mode they update
  their running statistics as flax does (biased batch variance).
- ``remat=True`` runs each MBConv block under ``layers.common.remat_call`` in
  train mode, as the JAX package wraps ``MBConvBlock`` in ``nn.remat``.
- In eval mode under ``quant.quantized("int8_static")`` the stem (3×3/s2, TF-SAME),
  the expand and project 1×1s and the depthwise k×k run as the static int8 sites
  that ``prepare_static_int8`` baked (``Conv_i`` with ``BatchNorm_i`` folded in; the
  depthwise through ``kernels.int8_conv.int8_dwconv``), each result cast to the
  input's type in the kernel's epilogue; under ``"calib"`` each site records its
  input's range. In every quant mode the float depthwise runs on stock torch ops,
  as the JAX package falls through to its stock path there, so no quantized or
  calibrating forward launches the fused float kernel. The dynamic ``"int8"`` mode
  leaves the backbone in float, as in the JAX package.
"""

from typing import List, Sequence

import torch
import torch.nn as nn

from tmv_tpu_torch.kernels.dwconv import fused_dw_bn_swish
from tmv_tpu_torch.models.efficientdet.config import (
    EfficientDetBlockArgs,
    round_filters,
    round_repeats,
)
from tmv_tpu_torch.models.layers.common import (
    BatchNorm, as_dtype, conv2d_same, conv_as_input, remat_call,
)
from tmv_tpu_torch.ops.activations import swish
from tmv_tpu_torch.ops.padding import same_pads
from tmv_tpu_torch.ops.space_to_depth import s2d_stem_conv
from tmv_tpu_torch.parallel import halo
from tmv_tpu_torch.quant.dynamic import quant_mode
from tmv_tpu_torch.quant.static import record, static_conv_site


def batch_norm(features: int, momentum: float, epsilon: float, device=None) -> BatchNorm:
    """Keras BatchNorm (momentum 0.99 is torch's 0.01), float32 parameters, with
    flax's running-statistics update in train mode."""
    return BatchNorm(features, eps=epsilon, momentum=1.0 - momentum, device=device)


class SE(nn.Module):
    """Squeeze-and-excitation gate."""

    def __init__(self, in_filters: int, se_filters: int, output_filters: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_filters, se_filters, 1, dtype=dtype, device=device)
        self.Conv_1 = nn.Conv2d(se_filters, output_filters, 1, dtype=dtype, device=device)

    def forward(self, x):
        se = halo.mean_hw(x)     # the whole image's, in a height-sharded forward
        se = conv_as_input(self.Conv_1, swish(conv_as_input(self.Conv_0, se)))
        return torch.sigmoid(se) * x


class Stem(nn.Module):
    """3×3 stride-2 conv (width-scaled) → BatchNorm → swish. ``stem_s2d`` computes the
    float conv as a 2×2 stride-1 conv over ``ops.space_to_depth.space_to_depth(x, 2)``
    (the same weights; JAX's opt-in ``stem_s2d``); the int8 site is unchanged."""

    def __init__(self, stem_filters: int, width_coefficient: float, depth_divisor: int,
                 bn_momentum: float = 0.99, bn_epsilon: float = 1e-3,
                 dtype=torch.float32, device=None, stem_s2d: bool = False):
        super().__init__()
        filters = round_filters(stem_filters, width_coefficient, depth_divisor)
        self.stem_s2d = stem_s2d
        self.Conv_0 = nn.Conv2d(3, filters, 3, 2, bias=False, dtype=dtype, device=device)
        self.BatchNorm_0 = batch_norm(filters, bn_momentum, bn_epsilon, device)

    def forward(self, x):
        mode = quant_mode()
        if mode == "int8_static" and not self.training:
            return swish(static_conv_site(self, "_Conv_0", x, (3, 3), 2, out_dtype=x.dtype))
        if mode == "calib":
            record(self, "in_absmax_Conv_0", x)
        weight = as_dtype(self.Conv_0.weight, x.dtype)
        if self.stem_s2d and halo.active() is not None:
            raise ValueError("stem_s2d does not run height-sharded")
        y = s2d_stem_conv(x, weight) if self.stem_s2d else conv2d_same(x, weight, None, 2)
        return swish(self.BatchNorm_0(y))


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck (reference variant: no residual skip)."""

    def __init__(self, block_args: EfficientDetBlockArgs, bn_momentum: float = 0.99,
                 bn_epsilon: float = 1e-3, dtype=torch.float32, device=None):
        super().__init__()
        args = block_args
        filters = args.input_filters * args.expand_ratio
        self.stride = tuple(args.strides)[0]
        kw = dict(dtype=dtype, device=device)
        ci = 0
        self.expand = args.expand_ratio != 1
        if self.expand:
            self.Conv_0 = nn.Conv2d(args.input_filters, filters, 1, bias=False, **kw)
            self.BatchNorm_0 = batch_norm(filters, bn_momentum, bn_epsilon, device)
            ci = 1
        self.add_module(f"Conv_{ci}", nn.Conv2d(filters, filters, args.kernel_size, self.stride,
                                                groups=filters, bias=False, device=device))
        self.add_module(f"BatchNorm_{ci}", batch_norm(filters, bn_momentum, bn_epsilon, device))
        num_reduced = max(1, int(args.input_filters * args.se_ratio))
        self.SE_0 = SE(filters, num_reduced, filters, **kw)
        self.add_module(f"Conv_{ci + 1}", nn.Conv2d(filters, args.output_filters, 1,
                                                    bias=False, **kw))
        self.add_module(f"BatchNorm_{ci + 1}",
                        batch_norm(args.output_filters, bn_momentum, bn_epsilon, device))
        self.dw_index = ci

    def forward(self, x):
        ci = self.dw_index
        mode = quant_mode()
        static, calib = mode == "int8_static" and not self.training, mode == "calib"
        dtype = x.dtype
        if self.expand:
            if static:
                x = swish(static_conv_site(self, "_Conv_0", x, (1, 1), out_dtype=dtype))
            else:
                if calib:
                    record(self, "in_absmax_Conv_0", x)
                x = swish(self.BatchNorm_0(conv_as_input(self.Conv_0, x)))
        conv, bn = getattr(self, f"Conv_{ci}"), getattr(self, f"BatchNorm_{ci}")
        k = conv.kernel_size[0]
        if static:
            x = swish(static_conv_site(self, f"_Conv_{ci}", x, (k, k), self.stride,
                                       out_dtype=dtype))
        elif self.training or mode != "off":
            # the stock path, as in JAX: in calibration (and dynamic int8, which
            # leaves the backbone float) the fused kernel is not launched
            if calib:
                record(self, f"in_absmax_Conv_{ci}", x)
            x = conv2d_same(x, as_dtype(conv.weight, x.dtype), None, self.stride,
                            groups=conv.groups)
            x = swish(bn(x))
        else:
            c = conv.out_channels
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            offset = bn.bias - bn.running_mean * scale
            taps = conv.weight.view(c, k * k).t().contiguous().view(k, k, c)
            if halo.active() is None:
                x = fused_dw_bn_swish(x, taps, scale, offset, self.stride)
            else:    # this shard's rows with their halo, and the row pads left
                top, bottom = same_pads(halo.global_height(x), k, self.stride)
                x, top, bottom = halo.window_rows(x, k, self.stride, top, bottom)
                x = fused_dw_bn_swish(x.contiguous(memory_format=torch.channels_last), taps,
                                      scale, offset, self.stride, row_pads=(top, bottom))
        x = self.SE_0(x)
        if static:
            return static_conv_site(self, f"_Conv_{ci + 1}", x, (1, 1), out_dtype=dtype)
        if calib:
            record(self, f"in_absmax_Conv_{ci + 1}", x)
        return getattr(self, f"BatchNorm_{ci + 1}")(
            conv_as_input(getattr(self, f"Conv_{ci + 1}"), x))


class BackboneModel(nn.Module):
    """Stem + scaled MBConv chain; returns ``[final, reduction_1..5]``."""

    def __init__(self, blocks_args: Sequence[EfficientDetBlockArgs],
                 width_coefficient: float = 1.0, depth_coefficient: float = 1.0,
                 depth_divisor: int = 8, bn_momentum: float = 0.99,
                 bn_epsilon: float = 1e-3, dtype=torch.float32, device=None,
                 remat: bool = False, stem_s2d: bool = False):
        super().__init__()
        self.remat = remat
        self.blocks_args = list(blocks_args)
        self.width_coefficient = width_coefficient
        self.depth_coefficient = depth_coefficient
        self.depth_divisor = depth_divisor
        self.Stem_0 = Stem(self.blocks_args[0].input_filters, width_coefficient, depth_divisor,
                           bn_momentum, bn_epsilon, dtype, device, stem_s2d)
        self.blocks = self.scaled_blocks()
        for idx, args in enumerate(self.blocks):
            self.add_module(f"MBConvBlock_{idx}",
                            MBConvBlock(args, bn_momentum, bn_epsilon, dtype, device))

    def scaled_blocks(self) -> List[EfficientDetBlockArgs]:
        """One entry per physical block, width- and depth-scaled."""
        flat = []
        for args in self.blocks_args:
            assert args.num_repeat > 0
            scaled = args._replace(
                input_filters=round_filters(args.input_filters, self.width_coefficient,
                                            self.depth_divisor),
                output_filters=round_filters(args.output_filters, self.width_coefficient,
                                             self.depth_divisor),
                num_repeat=round_repeats(args.num_repeat, self.depth_coefficient),
            )
            flat.append(scaled._replace(num_repeat=1))
            rest = scaled._replace(input_filters=scaled.output_filters, strides=(1, 1),
                                   num_repeat=1)
            flat.extend([rest] * (scaled.num_repeat - 1))
        return flat

    @property
    def out_channels(self) -> List[int]:
        """Channels of ``[final, reduction_1..5]``."""
        taps = [a.output_filters for i, a in enumerate(self.blocks)
                if i == len(self.blocks) - 1 or self.blocks[i + 1].strides[0] > 1]
        return [self.blocks[-1].output_filters] + taps

    def forward(self, x):
        x = self.Stem_0(x)
        reductions = []
        for idx in range(len(self.blocks)):
            x = remat_call(self.remat, getattr(self, f"MBConvBlock_{idx}"), x)
            is_last = idx == len(self.blocks) - 1
            if is_last or self.blocks[idx + 1].strides[0] > 1:
                reductions.append(x)
        return [x] + reductions
