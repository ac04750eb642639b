"""UNet keypoint-heatmap model.

Port of ``tmv_tpu/models/unet.py`` (the reference's `unet/model.py:6-117`): a
``depth``-stage encoder (two conv-BN-relu, the skip tapped before a 2×2
max-pool), a bottom stage, and a decoder whose stages resize the skip to the
upsampled size, concatenate it first, run two convs, then upsample ×2
(nearest), BatchNorm and sigmoid. The 1×1 head reads the *pre-upsample* output
of the last decoder stage. ``UNet`` returns the sigmoid heatmaps, ``UNetLogits``
the head's logits (the loss wants logits).

Submodules carry the flax names (``DownSample_d``, ``UpSample_i``,
``UNetConv_k``, ``Conv_0``, ``BatchNorm_0``), so ``convert.flax_bridge`` maps a
flax tree onto the ``state_dict``. The BatchNorms are ``layers.common.BatchNorm``
(momentum 0.99, epsilon 1e-3, flax's running-statistics update). The 3×3 convs
pad 1 (TF-SAME at stride 1). A skip is resized as ``jax.image.resize(...,
"bilinear")`` resizes it: half-pixel bilinear that antialiases when it shrinks
(a skip of an odd-sized map goes from 25 to 24 px), so ``F.interpolate`` runs
with ``antialias=True``. The model takes NHWC images and returns NHWC maps, the
JAX package's layout, and runs NCHW in ``channels_last`` memory inside.
``remat=True`` runs each ``DownSample`` and ``UpSample`` under
``layers.common.remat_call`` in train mode, as the JAX package wraps them in
``nn.remat``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.models.layers.common import BatchNorm, Conv2d, remat_call
from tmv_tpu_torch.ops.losses import sigmoid_cross_entropy

# stddev of a unit-variance normal truncated to ±2 (flax's variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


def _bn(features: int, device=None) -> BatchNorm:
    return BatchNorm(features, eps=1e-3, momentum=0.01, device=device)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``layers/common.py::resize_bilinear`` on NCHW: half-pixel bilinear,
    antialiased when it shrinks; the identity at the same size."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class UNetConv(nn.Module):
    """3×3 conv (bias) → BatchNorm → relu."""

    def __init__(self, in_features: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, filters, 3, padding=1, dtype=dtype, device=device)
        self.BatchNorm_0 = _bn(filters, device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class DownSample(nn.Module):
    """Two ``UNetConv`` → (skip, 2×2 max-pooled)."""

    def __init__(self, in_features: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        self.UNetConv_0 = UNetConv(in_features, filters, dtype, device)
        self.UNetConv_1 = UNetConv(filters, filters, dtype, device)

    def forward(self, x):
        p = self.UNetConv_1(self.UNetConv_0(x))
        return p, F.max_pool2d(p, 2, 2)


class UpSample(nn.Module):
    """(skip resized and concatenated first) → two ``UNetConv`` → (that output,
    its nearest ×2 upsample → BatchNorm → sigmoid)."""

    def __init__(self, in_features: int, filters: int, dtype=torch.float32, device=None):
        super().__init__()
        self.UNetConv_0 = UNetConv(in_features, filters, dtype, device)
        self.UNetConv_1 = UNetConv(filters, filters, dtype, device)
        self.BatchNorm_0 = _bn(filters, device)

    def forward(self, x, skip=None):
        if skip is not None:
            x = torch.cat([resize_bilinear(skip, x.shape[2:]), x], dim=1)
        p = self.UNetConv_1(self.UNetConv_0(x))
        x = F.interpolate(p, scale_factor=2, mode="nearest")
        return p, torch.sigmoid(self.BatchNorm_0(x))


class UNet(nn.Module):
    """NHWC image → NHWC sigmoid heatmaps of ``output_filters`` channels, at the
    size of the last decoder stage's input."""

    def __init__(self, depth: int = 4, filters_base: int = 64, output_filters: int = 1,
                 dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        self.depth, self.remat = depth, remat
        kw = dict(dtype=dtype, device=device)
        channels = 3
        for d in range(depth):
            self.add_module(f"DownSample_{d}", DownSample(channels, filters_base * 2 ** d, **kw))
            channels = filters_base * 2 ** d
        self.UpSample_0 = UpSample(channels, filters_base * 2 ** depth, **kw)
        channels = filters_base * 2 ** depth
        for i in range(depth):
            f = filters_base * 2 ** (depth - 1 - i)     # the decoder runs high → low
            self.add_module(f"UpSample_{i + 1}", UpSample(f + channels, f, **kw))
            channels = f
        self.Conv_0 = Conv2d(channels, output_filters, 1, **kw)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """The 1×1 head's NHWC logits."""
        x = images.permute(0, 3, 1, 2).to(self.Conv_0.weight.dtype,
                                          memory_format=torch.channels_last)
        skips = []
        for d in range(self.depth):
            p, x = remat_call(self.remat, getattr(self, f"DownSample_{d}"), x)
            skips.append(p)
        _, x = remat_call(self.remat, self.UpSample_0, x)
        for i, skip in enumerate(reversed(skips)):
            p, x = remat_call(self.remat, getattr(self, f"UpSample_{i + 1}"), x, skip)
        return self.Conv_0(p).permute(0, 2, 3, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(images))


class UNetLogits(UNet):
    """The variant that returns the 1×1 head's logits."""

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.logits(images)


@torch.no_grad()
def init_weights(model: UNet, seed: int) -> UNet:
    """Seeded init with the JAX package's initializers: the 3×3 convs
    ``he_normal`` (variance 2/fan_in, a normal truncated at ±2 std), the 1×1
    head flax's default ``lecun_normal`` (variance 1/fan_in), zero biases,
    identity BatchNorm. Drawn on the CPU from one ``torch.Generator`` in module
    order, so a seed gives the same weights on every device (not the JAX
    package's values: its draws are threefry's)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            gain = 1.0 if m is model.Conv_0 else 2.0
            std = math.sqrt(gain / fan_in) / _TRUNCATED_STD
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def make_unet_loss_fn():
    """Loss for ``core.train_state.make_train_step``: ``(model, batch) -> (loss,
    {})``, the mean sigmoid cross-entropy of the ``UNetLogits`` logits of
    ``batch["image"]`` against ``batch["target"]`` heatmaps, in train mode (the
    reference trains ``BinaryCrossentropy`` on sigmoid outputs,
    `unet/train.py:28-47`)."""

    def loss_fn(model, batch):
        logits = model.logits(batch["image"])
        return torch.mean(sigmoid_cross_entropy(batch["target"], logits)), {}

    return loss_fn
