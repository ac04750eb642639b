"""EfficientDet model dictionaries D0–D7x and compound-scaling math.

The port's own copy of ``tmv_tpu/models/efficientdet/config.py``:
``EfficientDetBlockArgs``, the EfficientNet-B0 base blocks, ``round_filters`` /
``round_repeats`` (width/depth scaling), the D0–D7x parameter dict and
``get_efficientdet_config`` with its ``levels_size`` halving chain.
"""

import math
from typing import NamedTuple, Tuple

from tmv_tpu_torch.core.config import Config


class EfficientDetBlockArgs(NamedTuple):
    num_repeat: int
    kernel_size: int
    strides: Tuple[int, int]
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float


def default_blocks_args():
    """EfficientNet-B0 base blocks."""
    return [
        EfficientDetBlockArgs(1, 3, (1, 1), 1, 32, 16, 0.25),
        EfficientDetBlockArgs(2, 3, (2, 2), 6, 16, 24, 0.25),
        EfficientDetBlockArgs(2, 5, (2, 2), 6, 24, 40, 0.25),
        EfficientDetBlockArgs(3, 3, (2, 2), 6, 40, 80, 0.25),
        EfficientDetBlockArgs(3, 5, (1, 1), 6, 80, 112, 0.25),
        EfficientDetBlockArgs(4, 5, (2, 2), 6, 112, 192, 0.25),
        EfficientDetBlockArgs(1, 3, (1, 1), 6, 192, 320, 0.25),
    ]


def round_filters(filters, width_coefficient, depth_divisor) -> int:
    """Width scaling with a 10% round-down floor."""
    filters *= width_coefficient
    min_depth = depth_divisor
    new_filters = max(
        min_depth, int(filters + depth_divisor / 2) // depth_divisor * depth_divisor
    )
    if new_filters < 0.9 * filters:
        new_filters += depth_divisor
    return int(new_filters)


def round_repeats(repeats, depth_coefficient) -> int:
    """Depth scaling."""
    return int(math.ceil(depth_coefficient * repeats))


efficientdet_model_param_dict = {
    "efficientdet-d0": dict(
        name="efficientdet-d0", backbone_name="efficientnet-b0",
        image_size=512, fpn_num_filters=64, fpn_cell_repeats=3,
        box_class_repeats=3, width_coefficient=1.0, depth_coefficient=1.0,
        dropout_rate=0.2,
    ),
    "efficientdet-d1": dict(
        name="efficientdet-d1", backbone_name="efficientnet-b1",
        image_size=640, fpn_num_filters=88, fpn_cell_repeats=4,
        box_class_repeats=3, width_coefficient=1.0, depth_coefficient=1.1,
        dropout_rate=0.2,
    ),
    "efficientdet-d1-a": dict(
        name="efficientdet-d1-a", backbone_name="efficientnet-b1-a",
        image_size=640, fpn_num_filters=88, fpn_cell_repeats=4,
        box_class_repeats=3, width_coefficient=0.8, depth_coefficient=0.8,
        dropout_rate=0.2,
    ),
    "efficientdet-d2": dict(
        name="efficientdet-d2", backbone_name="efficientnet-b2",
        image_size=768, fpn_num_filters=112, fpn_cell_repeats=5,
        box_class_repeats=3, width_coefficient=1.1, depth_coefficient=1.2,
        dropout_rate=0.3,
    ),
    "efficientdet-d3": dict(
        name="efficientdet-d3", backbone_name="efficientnet-b3",
        image_size=896, fpn_num_filters=160, fpn_cell_repeats=6,
        box_class_repeats=4, width_coefficient=1.2, depth_coefficient=1.4,
        dropout_rate=0.3,
    ),
    "efficientdet-d4": dict(
        name="efficientdet-d4", backbone_name="efficientnet-b4",
        image_size=1024, fpn_num_filters=224, fpn_cell_repeats=7,
        box_class_repeats=4, width_coefficient=1.4, depth_coefficient=1.8,
        dropout_rate=0.4,
    ),
    "efficientdet-d5": dict(
        name="efficientdet-d5", backbone_name="efficientnet-b5",
        image_size=1280, fpn_num_filters=288, fpn_cell_repeats=7,
        box_class_repeats=4, width_coefficient=1.6, depth_coefficient=2.2,
        dropout_rate=0.4,
    ),
    "efficientdet-d6": dict(
        name="efficientdet-d6", backbone_name="efficientnet-b6",
        image_size=1280, fpn_num_filters=384, fpn_cell_repeats=8,
        box_class_repeats=5, fpn_weight_method="sum",
        width_coefficient=1.8, depth_coefficient=2.6, dropout_rate=0.5,
    ),
    "efficientdet-d7": dict(
        name="efficientdet-d7", backbone_name="efficientnet-b6",
        image_size=1536, fpn_num_filters=384, fpn_cell_repeats=8,
        box_class_repeats=5, anchor_scale=5.0, fpn_weight_method="sum",
        width_coefficient=1.8, depth_coefficient=2.6, dropout_rate=0.5,
    ),
    "efficientdet-d7x": dict(
        name="efficientdet-d7x", backbone_name="efficientnet-b7",
        image_size=1536, fpn_num_filters=384, fpn_cell_repeats=8,
        box_class_repeats=5, anchor_scale=4.0, max_level=8,
        fpn_weight_method="sum",
        width_coefficient=2.0, depth_coefficient=3.1, dropout_rate=0.5,
    ),
}


def default_detection_configs() -> Config:
    h = Config()
    h.name = ""
    h.backbone_name = ""
    h.batch_norm_momentum = 0.99
    h.batch_norm_epsilon = 1e-3
    h.width_coefficient = 1.0
    h.depth_coefficient = 1.0
    h.dropout_rate = 0.2
    h.depth_divisor = 8
    h.min_level = 3
    h.max_level = 7
    h.image_size = 512
    h.fpn_num_filters = 88
    h.fpn_cell_repeats = 4
    h.fpn_weight_method = "fastattn"
    h.box_class_repeats = 3
    h.is_training_bn = True
    h.num_scales = 3
    h.aspect_ratios = [(1.0, 1.0), (1.4, 0.7), (0.7, 1.4)]
    h.anchor_scale = 4.0
    h.num_classes = 81  # 0 reserved for background
    h.survival_prob = 0.8
    h.alpha = 0.25
    h.gamma = 1.5
    h.nms_configs = {
        "method": "gaussian",
        "iou_thresh": None,
        "score_thresh": None,
        "sigma": None,
        "max_nms_inputs": 0,
        "max_output_size": 1000,
    }
    return h


def get_efficientdet_config(model_name: str = "efficientdet-d4") -> Config:
    """Config for a model name, with the levels_size halving chain."""
    h = default_detection_configs()
    if model_name not in efficientdet_model_param_dict:
        raise ValueError(f"Unknown model name: {model_name}")
    h.override(efficientdet_model_param_dict[model_name], allow_new_keys=True)
    h.levels_size = [h.image_size]
    for _ in range(h.max_level):
        h.levels_size.append((h.levels_size[-1] + 1) // 2)
    return h
