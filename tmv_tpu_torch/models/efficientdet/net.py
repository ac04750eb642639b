"""EfficientDetNet: backbone → P6/P7 resample → BiFPN cells → heads.

Port of ``tmv_tpu/models/efficientdet/net.py::EfficientDetNet`` and
``make_efficientdet_loss_fn``. The network takes NHWC images, as the
JAX package's does, runs NCHW in ``channels_last`` memory inside, and returns
``(boxes_outputs, classes_outputs)``: tuples over levels of ``(B, h, w, A, 4)``
and ``(B, h, w, A, num_classes)`` heads. There is no fused-depthwise switch: the
eval MBConv depthwise always goes through ``kernels.dwconv``. A config with
``remat`` set runs the MBConv blocks, the BiFPN cells, ``ClassNet`` and
``BoxNet`` under ``layers.common.remat_call`` in train mode, the modules the
JAX package wraps in ``nn.remat``; the heads' recompute draws the same
``drop_connect`` masks from the generator as their forward.
"""

import math

import torch
import torch.nn as nn

from tmv_tpu_torch.models.efficientdet.backbone import BackboneModel
from tmv_tpu_torch.models.efficientdet.bifpn import BiFPN, ResampleFeatureMap
from tmv_tpu_torch.models.efficientdet.config import default_blocks_args
from tmv_tpu_torch.models.efficientdet.heads import BoxNet, ClassNet
from tmv_tpu_torch.models.layers.common import remat_call
from tmv_tpu_torch.ops.losses import box_loss, focal_loss, l2_regularization
from tmv_tpu_torch.parallel.collectives import global_sum, world
from tmv_tpu_torch.parallel.halo import once_over_space

CLASS_PRIOR = 0.01


class EfficientDetNet(nn.Module):
    """Forward: NHWC image → (boxes_outputs, classes_outputs), tuples over levels.

    ``dtype`` is the activations' type, ``param_dtype`` (default: ``dtype``) the
    type the conv weights are held in: the serving predictors hold bf16 weights,
    the trainer float32 master weights under bf16 activations. ``forward`` takes
    the ``torch.Generator`` of the heads' ``drop_connect`` draws in train mode."""

    def __init__(self, config, dtype: torch.dtype = torch.float32, device=None,
                 param_dtype=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.remat = bool(cfg.get("remat", False))
        bn = dict(bn_momentum=cfg.batch_norm_momentum, bn_epsilon=cfg.batch_norm_epsilon,
                  dtype=param_dtype or dtype, device=device)
        filters = cfg.fpn_num_filters
        self.backbone = BackboneModel(default_blocks_args(), cfg.width_coefficient,
                                      cfg.depth_coefficient, cfg.depth_divisor,
                                      remat=self.remat,
                                      stem_s2d=bool(cfg.get("stem_s2d", False)), **bn)
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
                    dtype=param_dtype or dtype, device=device)
        self.class_net = ClassNet(num_classes=cfg.num_classes, **head)
        self.box_net = BoxNet(**head)

    def forward(self, images: torch.Tensor, generator=None):
        cfg = self.config
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        feats = list(self.backbone(x)[cfg.min_level:cfg.max_level + 1])
        for level in range(6, cfg.max_level + 1):
            feats.append(getattr(self, f"resample_p{level}")(feats[-1]))
        for rep in range(cfg.fpn_cell_repeats):
            feats = remat_call(self.remat, getattr(self, f"fpn_cell_{rep}"), feats)
        drawn = (generator,) if generator is not None else ()
        classes = remat_call(self.remat, self.class_net, feats, generator,
                             generators=drawn)     # flax's call order
        return remat_call(self.remat, self.box_net, feats, generator, generators=drawn), classes


# stddev of a unit-variance normal truncated to ±2 (flax's variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: EfficientDetNet, seed: int) -> EfficientDetNet:
    """Seeded init with the JAX package's D0 initializers: backbone convs
    N(0, 2/fan_out) (``conv_kernel_init``; fan_out = k·k·out, k·k for a
    depthwise kernel), the BiFPN's and heads' separable convs and the resample
    1×1 convs variance-scaling 1/fan_in from a normal truncated at ±2 std
    (flax's ``lecun_normal``), zero biases, identity BatchNorm, BiFPN fusion
    weights of 1, and the ClassNet predict bias at the focal-loss prior
    ``−log((1 − 0.01) / 0.01)``. Values are drawn on the CPU from one
    ``torch.Generator`` in module order, so a seed gives the same weights on
    every device (not the JAX package's values: its draws are threefry's)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            out, in_per_group, kh, kw = m.weight.shape
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            if name.startswith("backbone."):
                fan_out = kh * kw * (1 if m.groups > 1 else out)
                w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
            else:
                std = math.sqrt(1.0 / (kh * kw * in_per_group)) / _TRUNCATED_STD
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1].startswith("WSM_"):
            p.fill_(1.0)
    model.class_net.net.predict.pointwise.bias.fill_(-math.log((1 - CLASS_PRIOR) / CLASS_PRIOR))
    return model


def efficientdet_loss(model, outputs, batch, weight_decay: float = 4e-5,
                      reference_focal_reduction: bool = False) -> torch.Tensor:
    """``l2(weight_decay) + Σ_levels (50 · box_loss + focal)`` of the heads
    ``outputs = (boxes, classes)`` against the per-level ``batch["boxes"]``,
    ``batch["classes"]`` and ``batch["masks"]`` of ``Anchors.generate_targets``,
    with ``num_positives = 1 + Σ masks`` over all levels and the batch. The focal
    term is reduced by automl's sum (divided by ``num_positives``) unless
    ``reference_focal_reduction`` takes the reference's Keras mean over all
    elements, which leaves the classifier untrained (see the JAX function).

    In a data-parallel step over R ranks ``num_positives`` is the global batch's
    (all-reduced, detached) and each summed data term is scaled by R, so that the
    mean of the ranks' losses is the global loss; the mean-reduced focal term and
    the l2 term are not scaled. In a height-sharded step every space rank computes the
    l2 term whole from the parameters; its gradient is taken on one of them
    (``parallel.halo.once_over_space``)."""
    cfg = model.config
    y_pred_boxes, y_pred_classes = outputs
    # every space shard of a height-sharded step computes it whole: its gradient once
    loss = once_over_space(l2_regularization(model, weight_decay))
    num_positives = 1.0 + global_sum(sum(torch.sum(m.to(torch.float32))
                                         for m in batch["masks"]))
    ranks = world()
    for level in range(len(batch["boxes"])):
        loss_b = box_loss(batch["boxes"][level], y_pred_boxes[level], num_positives)
        per_elem = focal_loss(batch["classes"][level], y_pred_classes[level], num_positives,
                              alpha=cfg.alpha, gamma=cfg.gamma)
        loss_c = (torch.mean(per_elem) if reference_focal_reduction
                  else torch.sum(per_elem) * ranks)
        loss = loss + loss_b * (50.0 * ranks) + loss_c
    return loss


def make_efficientdet_loss_fn(weight_decay: float = 4e-5,
                              reference_focal_reduction: bool = False,
                              generator=None):
    """Loss for ``core.train_state.make_train_step``: ``(model, batch) -> (loss,
    {})``, the model run on ``batch["image"]`` (in train mode, as the step sets
    it; ``generator`` feeds the heads' ``drop_connect``), then
    ``efficientdet_loss``."""

    def loss_fn(model, batch):
        outputs = model(batch["image"], generator=generator)
        return efficientdet_loss(model, outputs, batch, weight_decay,
                                 reference_focal_reduction), {}

    return loss_fn
