"""EfficientDetNet: backbone → P6/P7 resample → BiFPN cells → heads.

Port of ``tmv_tpu/models/efficientdet/net.py::EfficientDetNet`` (the forward;
the loss waits for the training slice). The network takes NHWC images, as the
JAX package's does, runs NCHW in ``channels_last`` memory inside, and returns
``(boxes_outputs, classes_outputs)``: tuples over levels of ``(B, h, w, A, 4)``
and ``(B, h, w, A, num_classes)`` heads. There is no fused-depthwise switch: the
eval MBConv depthwise always goes through ``kernels.dwconv``.
"""

import math

import torch
import torch.nn as nn

from tmv_tpu_torch.models.efficientdet.backbone import BackboneModel
from tmv_tpu_torch.models.efficientdet.bifpn import BiFPN, ResampleFeatureMap
from tmv_tpu_torch.models.efficientdet.config import default_blocks_args
from tmv_tpu_torch.models.efficientdet.heads import BoxNet, ClassNet
from tmv_tpu_torch.models.layers import common

CLASS_PRIOR = 0.01


class EfficientDetNet(nn.Module):
    """Forward: NHWC image → (boxes_outputs, classes_outputs), tuples over levels."""

    def __init__(self, config, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        bn = dict(bn_momentum=cfg.batch_norm_momentum, bn_epsilon=cfg.batch_norm_epsilon,
                  dtype=dtype, device=device)
        filters = cfg.fpn_num_filters
        self.backbone = BackboneModel(default_blocks_args(), cfg.width_coefficient,
                                      cfg.depth_coefficient, cfg.depth_divisor, **bn)
        # [final, r1..r5] indexed min_level..max_level → r3, r4, r5
        channels = self.backbone.out_channels[cfg.min_level:cfg.max_level + 1]
        for level in range(6, cfg.max_level + 1):
            self.add_module(f"resample_p{level}", ResampleFeatureMap(
                channels[-1], filters, cfg.levels_size[level], **bn))
            channels.append(filters)
        levels_size = cfg.levels_size[cfg.min_level:cfg.max_level + 1]
        for rep in range(cfg.fpn_cell_repeats):
            self.add_module(f"fpn_cell_{rep}", BiFPN(
                filters, levels_size, channels, cfg.get("fpn_weight_method", "fastattn"), **bn))
            channels = [filters] * len(levels_size)
        num_levels = cfg.max_level - cfg.min_level + 1
        num_anchors = len(cfg.aspect_ratios) * cfg.num_scales
        head = dict(num_anchors=num_anchors, num_filters=filters, num_levels=num_levels,
                    repeats=cfg.box_class_repeats, survival_prob=cfg.survival_prob,
                    dtype=dtype, device=device)
        self.class_net = ClassNet(num_classes=cfg.num_classes, **head)
        self.box_net = BoxNet(**head)

    def forward(self, images: torch.Tensor):
        cfg = self.config
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        feats = list(self.backbone(x)[cfg.min_level:cfg.max_level + 1])
        for level in range(6, cfg.max_level + 1):
            feats.append(getattr(self, f"resample_p{level}")(feats[-1]))
        for rep in range(cfg.fpn_cell_repeats):
            feats = getattr(self, f"fpn_cell_{rep}")(feats)
        return self.box_net(feats), self.class_net(feats)


@torch.no_grad()
def init_weights(model: EfficientDetNet, seed: int) -> EfficientDetNet:
    """Seeded init: He-uniform conv kernels, zero biases, identity BatchNorm,
    BiFPN fusion weights of 1, and the ClassNet predict bias at the focal-loss
    prior ``−log((1 − 0.01) / 0.01)``."""
    common.init_weights(model, seed)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1].startswith("WSM_"):
            p.fill_(1.0)
    model.class_net.net.predict.pointwise.bias.fill_(-math.log((1 - CLASS_PRIOR) / CLASS_PRIOR))
    return model
