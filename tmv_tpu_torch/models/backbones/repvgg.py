"""RepVGG with structural reparameterization.

Port of ``tmv_tpu/models/backbones/repvgg.py``:

- ``ConvBn``: a conv without bias (``conv``) → BatchNorm (``bn``), padded
  ``k // 2`` on both sides (not TF-SAME), so that the 1 × 1 branch folded into
  the centre of a 3 × 3 kernel samples the same pixels at stride 2;
- ``RepVGGBlock``: the train-time 3 × 3 (``rbr_dense``) + 1 × 1 (``rbr_1x1``) +
  identity-BatchNorm (``rbr_identity``, where the channels and the size are
  kept) branches under one relu; deploy-time one biased 3 × 3 conv
  (``rbr_reparam``);
- ``RepVGG``: the stages of ``stage_plan`` (blocks ``stage{s}_block{b}``) and a
  ``dense`` head over the mean of H and W; ``num_classes=0`` returns each
  stage's output;
- the A0-B3g4 table, ``get_repvgg_by_name`` and ``repvgg_convert_params``, which
  folds a train model's branches into the deploy model's ``state_dict``: the
  BatchNorm fold (kernel·γ/σ, bias β − μγ/σ), the 1 × 1 kernel zero-padded to
  3 × 3 and the identity as a grouped one-hot 3 × 3 kernel.

The names are the flax ones, so ``convert.flax_bridge`` maps a flax tree onto a
model. NCHW in; ``remat=True`` runs every block under ``layers.common.remat_call``
in train mode, as the JAX package wraps ``RepVGGBlock`` in ``nn.remat``.
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmv_tpu_torch.models.layers.common import BatchNorm, remat_call


def _bn(features: int, device=None) -> BatchNorm:
    return BatchNorm(features, eps=1e-3, momentum=0.01, device=device)


class ConvBn(nn.Module):
    def __init__(self, in_features: int, filters: int, kernel_size: int, strides: int = 1,
                 groups: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_features, filters, kernel_size, strides, kernel_size // 2,
                              groups=groups, bias=False, device=device)
        self.bn = _bn(filters, device)

    def forward(self, x):
        return self.bn(self.conv(x))


class RepVGGBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1, groups: int = 1,
                 deploy: bool = False, device=None):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_features, filters, 3, strides, 1, groups=groups,
                                         device=device)
            return
        self.rbr_dense = ConvBn(in_features, filters, 3, strides, groups, device)
        self.rbr_1x1 = ConvBn(in_features, filters, 1, strides, groups, device)
        if in_features == filters and strides == 1:
            self.rbr_identity = _bn(in_features, device)

    def forward(self, x):
        if self.deploy:
            return F.relu(self.rbr_reparam(x))
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if hasattr(self, "rbr_identity"):
            y = y + self.rbr_identity(x)
        return F.relu(y)


class RepVGG(nn.Module):
    """NCHW images → ``(B, num_classes)``, or ``{"stage{s}": map}`` when
    ``num_classes`` is 0."""

    def __init__(self, num_blocks: Sequence[int], num_classes: int = 1000,
                 width_multiplier: Sequence[float] = (1.0, 1.0, 1.0, 2.5),
                 override_groups_map: Optional[Dict[int, int]] = None, deploy: bool = False,
                 device=None, remat: bool = False):
        super().__init__()
        self.num_blocks, self.width_multiplier = tuple(num_blocks), tuple(width_multiplier)
        self.override_groups_map = override_groups_map
        self.num_classes, self.deploy, self.remat = num_classes, deploy, remat
        self.names = []
        channels = 3
        for si, stage_blocks in enumerate(self.stage_plan()):
            for bi, (planes, stride, groups) in enumerate(stage_blocks):
                name = f"stage{si}_block{bi}"
                self.add_module(name, RepVGGBlock(channels, planes, stride, groups, deploy,
                                                  device))
                self.names.append((si, name))
                channels = planes
        if num_classes:
            self.dense = nn.Linear(channels, num_classes, device=device)

    def stage_plan(self):
        """(filters, stride, groups) per block per stage (stage0 included)."""
        groups_map = self.override_groups_map or {}
        wm = self.width_multiplier
        plan = [[(min(64, int(64 * wm[0])), 2, 1)]]
        layer_idx = 1
        for stage, (base, blocks) in enumerate(zip((64, 128, 256, 512), self.num_blocks)):
            planes = int(base * wm[stage])
            stage_blocks = []
            for i in range(blocks):
                stage_blocks.append((planes, 2 if i == 0 else 1, groups_map.get(layer_idx, 1)))
                layer_idx += 1
            plan.append(stage_blocks)
        return plan

    def forward(self, x):
        outs = {}
        for si, name in self.names:
            x = remat_call(self.remat, getattr(self, name), x)
            outs[f"stage{si}"] = x
        if self.num_classes:
            return self.dense(torch.mean(x, dim=(2, 3)))
        return outs


_OPTIONAL_GROUPWISE = [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26]
_G2 = {layer: 2 for layer in _OPTIONAL_GROUPWISE}
_G4 = {layer: 4 for layer in _OPTIONAL_GROUPWISE}

_VARIANTS = {
    "RepVGG-A0": dict(num_blocks=(2, 4, 14, 1), width_multiplier=(0.75, 0.75, 0.75, 2.5), override_groups_map=None),
    "RepVGG-A1": dict(num_blocks=(2, 4, 14, 1), width_multiplier=(1, 1, 1, 2.5), override_groups_map=None),
    "RepVGG-A2": dict(num_blocks=(2, 4, 14, 1), width_multiplier=(1.5, 1.5, 1.5, 2.75), override_groups_map=None),
    "RepVGG-B0": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(1, 1, 1, 2.5), override_groups_map=None),
    "RepVGG-B1": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(2, 2, 2, 4), override_groups_map=None),
    "RepVGG-B1g2": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(2, 2, 2, 4), override_groups_map=_G2),
    "RepVGG-B1g4": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(2, 2, 2, 4), override_groups_map=_G4),
    "RepVGG-B2": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(2.5, 2.5, 2.5, 5), override_groups_map=None),
    "RepVGG-B2g2": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(2.5, 2.5, 2.5, 5), override_groups_map=_G2),
    "RepVGG-B2g4": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(2.5, 2.5, 2.5, 5), override_groups_map=_G4),
    "RepVGG-B3": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(3, 3, 3, 5), override_groups_map=None),
    "RepVGG-B3g2": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(3, 3, 3, 5), override_groups_map=_G2),
    "RepVGG-B3g4": dict(num_blocks=(4, 6, 16, 1), width_multiplier=(3, 3, 3, 5), override_groups_map=_G4),
}


def get_repvgg_by_name(name: str, num_classes: int = 1000, deploy: bool = False, device=None,
                       remat: bool = False) -> RepVGG:
    return RepVGG(num_classes=num_classes, deploy=deploy, device=device, remat=remat,
                  **_VARIANTS[name])


def _fuse_convbn(kernel, bn: BatchNorm):
    """(kernel·γ/σ, β − μγ/σ) of a conv kernel (OIHW) followed by ``bn``."""
    std = torch.sqrt(bn.running_var + bn.eps)
    return kernel * (bn.weight / std).reshape(-1, 1, 1, 1), bn.bias - bn.running_mean * bn.weight / std


@torch.no_grad()
def repvgg_convert_params(model: RepVGG) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the deploy twin of the train-mode ``model``
    (``RepVGG(..., deploy=True)`` with the same plan), on the model's device and
    in its type."""
    out: Dict[str, torch.Tensor] = {}
    for _, name in model.names:
        block = getattr(model, name)
        k3, b3 = _fuse_convbn(block.rbr_dense.conv.weight, block.rbr_dense.bn)
        k1, b1 = _fuse_convbn(block.rbr_1x1.conv.weight, block.rbr_1x1.bn)
        kernel, bias = k3 + F.pad(k1, (1, 1, 1, 1)), b3 + b1
        if hasattr(block, "rbr_identity"):
            in_ch, input_dim = kernel.shape[0], kernel.shape[1]   # in = out channels here
            kid = torch.zeros_like(kernel)
            kid[torch.arange(in_ch), torch.arange(in_ch) % input_dim, 1, 1] = 1.0
            kf, bf = _fuse_convbn(kid, block.rbr_identity)
            kernel, bias = kernel + kf, bias + bf
        out[f"{name}.rbr_reparam.weight"] = kernel
        out[f"{name}.rbr_reparam.bias"] = bias
    if model.num_classes:
        out["dense.weight"] = model.dense.weight.clone()
        out["dense.bias"] = model.dense.bias.clone()
    return out
