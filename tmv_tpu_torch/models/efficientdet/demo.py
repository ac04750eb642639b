"""Toy 7-conv pyramid detector: the anchors, focal and box-loss validation rig.

Port of ``tmv_tpu/models/efficientdet/demo.py`` (the reference's
`AIServer/ai_api/ai_models/efficientnet/demo/model.py:3-43`): seven 3x3 conv +
2x2 max-pool stages, no activation; stages 2 to 6 emit 9-anchor class and box heads.
It validates the anchor target, decode and loss stack before the full EfficientDet.

The convs carry flax's auto-names in call order (``Conv_0``, ``Conv_1``, then per
stage from 2 on its conv, its class head and its box head), so that
``convert.flax_bridge`` maps a flax tree onto the module. The forward takes NHWC
images, as the flax model, and returns ``(classes_outputs, boxes_outputs)``: tuples
over the five levels of ``(B, h, w, A, num_classes)`` and ``(B, h, w, A, 4)``.
"""

import torch
import torch.nn as nn

from tmv_tpu_torch.models.layers.common import conv2d_same, conv_as_input, max_pool_same
from tmv_tpu_torch.ops.losses import box_loss, focal_loss

STAGES = 7
FIRST_HEAD = 2


class DemoModel(nn.Module):
    def __init__(self, num_classes: int = 81, num_anchors: int = 9,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        kw = dict(dtype=dtype, device=device)
        self.stages, self.heads = [], []
        index, channels = 0, 3
        for i in range(STAGES):
            filters = 20 * (i + 1)
            self.stages.append(self._conv(index, channels, filters, 3, kw))
            index, channels = index + 1, filters
            if i >= FIRST_HEAD:
                cls = self._conv(index, channels, num_anchors * num_classes, 1, kw)
                box = self._conv(index + 1, channels, num_anchors * 4, 1, kw)
                self.heads.append((cls, box))
                index += 2

    def _conv(self, index, cin, cout, k, kw):
        name = f"Conv_{index}"
        self.add_module(name, nn.Conv2d(cin, cout, k, **kw))
        return name

    def _head(self, name, x):
        b, _, h, w = x.shape
        y = conv_as_input(getattr(self, name), x)
        return y.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors, -1)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(self.Conv_0.weight.dtype)
        classes_outputs, boxes_outputs = [], []
        for i, name in enumerate(self.stages):
            conv = getattr(self, name)
            x = max_pool_same(conv2d_same(x, conv.weight, conv.bias), 2, 2)
            if i >= FIRST_HEAD:
                cls, box = self.heads[i - FIRST_HEAD]
                classes_outputs.append(self._head(cls, x))
                boxes_outputs.append(self._head(box, x))
        return tuple(classes_outputs), tuple(boxes_outputs)


def make_demo_loss_fn(alpha: float = 0.25, gamma: float = 1.5):
    """The demo trainer's loss (`demo/demo_model_train.py`), for
    ``core.train_state.make_train_step``: ``(model, batch) -> (loss, {})`` with
    ``num_positives = 1 + Σ masks``, per level 50 × ``box_loss`` plus the mean of
    ``focal_loss``. ``batch`` holds ``image`` and per-level ``classes``, ``boxes``
    and ``masks``."""

    def loss_fn(model, batch):
        classes_out, boxes_out = model(batch["image"])
        num_positives = 1.0
        for mask in batch["masks"]:
            num_positives = num_positives + torch.sum(mask.to(torch.float32))
        loss = 0.0
        for level in range(len(boxes_out)):
            loss = loss + box_loss(batch["boxes"][level], boxes_out[level], num_positives) * 50.0
            loss = loss + torch.mean(focal_loss(batch["classes"][level], classes_out[level],
                                                num_positives, alpha=alpha, gamma=gamma))
        return loss, {}

    return loss_fn
