"""ClassNet / BoxNet prediction heads.

Port of ``tmv_tpu/models/efficientdet/heads.py``: ``repeats`` separable convs
*shared across levels* with *per-level* BatchNorms (``bn_{i}_level_{l}``), swish
after each, and a final separable ``predict`` conv; outputs reshaped to
``(B, h, w, A, C)`` / ``(B, h, w, A, 4)``.

With a ``survival_prob`` (0.8 in every D-config) the residual ``image +
original`` for ``i > 0`` is added in eval too; only ``drop_connect`` (stochastic
depth, ``ops/regularizers.py``) is train-only. Its uniform draws come from the
``torch.Generator`` the caller passes to ``forward`` (on the activations'
device), as flax draws them from the ``dropout`` rng; train mode with a
``survival_prob`` below 1 and no generator raises. The class prior bias ``−log((1 − 0.01) / 0.01)`` of the
ClassNet predict conv is set by ``net.init_weights``, as the JAX package sets it
after ``init`` (``init_class_prior_bias``).
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tmv_tpu_torch.models.efficientdet.backbone import batch_norm
from tmv_tpu_torch.models.efficientdet.bifpn import SeparableConv
from tmv_tpu_torch.ops.activations import swish
from tmv_tpu_torch.ops.regularizers import drop_connect
from tmv_tpu_torch.parallel.collectives import draw_rows


def draw_uniform(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One uniform [0, 1) draw per sample of ``x``, shaped ``(B, 1, …)``, in x's
    dtype, from ``generator``; in a data-parallel step this rank's rows of the
    global batch's draw (``parallel.collectives.draw_rows``)."""
    ones = (1,) * (x.dim() - 1)
    return draw_rows(lambda n: torch.rand((n,) + ones, generator=generator, dtype=x.dtype,
                                          device=x.device), x.shape[0])


class PredictionNet(nn.Module):
    """Shared structure of ClassNet and BoxNet."""

    def __init__(self, out_per_anchor: int, num_anchors: int, num_filters: int,
                 num_levels: int, repeats: int, survival_prob: Optional[float],
                 bn_momentum: float = 0.99, bn_epsilon: float = 1e-3,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.out_per_anchor, self.num_anchors = out_per_anchor, num_anchors
        self.num_levels, self.repeats = num_levels, repeats
        self.survival_prob = survival_prob
        for i in range(repeats):
            self.add_module(f"conv_{i}", SeparableConv(num_filters, num_filters, 3, True,
                                                       dtype, device))
        # the final logits stay float on the int8 path
        self.predict = SeparableConv(num_filters, out_per_anchor * num_anchors, 3, True,
                                     dtype, device, quantize=False)
        for i in range(repeats):
            for level in range(num_levels):
                self.add_module(f"bn_{i}_level_{level}",
                                batch_norm(num_filters, bn_momentum, bn_epsilon, device))

    def forward(self, inputs: Sequence[torch.Tensor], generator: Optional[torch.Generator] = None):
        drop = self.training and self.survival_prob and self.survival_prob < 1.0
        if drop and generator is None:
            raise ValueError("train mode with survival_prob < 1 needs a torch.Generator "
                             "for drop_connect")
        outputs = []
        for level in range(self.num_levels):
            image = inputs[level]
            for i in range(self.repeats):
                original = image
                image = getattr(self, f"conv_{i}")(image)
                image = swish(getattr(self, f"bn_{i}_level_{level}")(image))
                if i > 0 and self.survival_prob:
                    if drop:
                        image = drop_connect(image, self.survival_prob,
                                             draw_uniform(image, generator))
                    image = image + original
            out = self.predict(image)
            b, _, h, w = out.shape
            outputs.append(out.permute(0, 2, 3, 1).reshape(
                b, h, w, self.num_anchors, self.out_per_anchor))
        return tuple(outputs)


class ClassNet(nn.Module):
    def __init__(self, num_classes: int = 90, num_anchors: int = 9, num_filters: int = 32,
                 num_levels: int = 5, repeats: int = 4, survival_prob: Optional[float] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.net = PredictionNet(num_classes, num_anchors, num_filters, num_levels, repeats,
                                 survival_prob, dtype=dtype, device=device)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        return self.net(inputs, generator)


class BoxNet(nn.Module):
    def __init__(self, num_anchors: int = 9, num_filters: int = 32, num_levels: int = 5,
                 repeats: int = 4, survival_prob: Optional[float] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.net = PredictionNet(4, num_anchors, num_filters, num_levels, repeats,
                                 survival_prob, dtype=dtype, device=device)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        return self.net(inputs, generator)
