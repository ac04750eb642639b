"""Detection visualization: boxes / keypoints / masks on image arrays.

The port's own copy of ``tmv_tpu/visualize/vis_utils.py`` (PIL and numpy).

Capability parity with the reference's vendored TF object-detection
visualization library (`AIServer/ai_api/ai_models/visualize/vis_utils.py:95-1150`):
per-box colored rectangles with multi-line labels, normalized or absolute
coordinates, keypoint dots, alpha-blended instance masks, and the top-level
``visualize_boxes_and_labels_on_image_array`` orchestration (score
threshold, max boxes, class→color assignment, agnostic mode).  Fresh
PIL/numpy implementation (the vendored copy depended on TF tensors for its
summary variants; array-mode capability is what the repo exercises).
"""

import collections
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

STANDARD_COLORS = [
    "AliceBlue", "Chartreuse", "Aqua", "Aquamarine", "Azure", "Beige",
    "Bisque", "BlanchedAlmond", "BlueViolet", "BurlyWood", "CadetBlue",
    "AntiqueWhite", "Chocolate", "Coral", "CornflowerBlue", "Cornsilk",
    "Crimson", "Cyan", "DarkCyan", "DarkGoldenRod", "DarkGrey", "DarkKhaki",
    "DarkOrange", "DarkOrchid", "DarkSalmon", "DarkSeaGreen", "DarkTurquoise",
    "DarkViolet", "DeepPink", "DeepSkyBlue", "DodgerBlue", "FireBrick",
    "FloralWhite", "ForestGreen", "Fuchsia", "Gainsboro", "GhostWhite",
    "Gold", "GoldenRod", "Salmon", "Tan", "HoneyDew", "HotPink", "IndianRed",
    "Ivory", "Khaki", "Lavender", "LavenderBlush", "LawnGreen",
    "LemonChiffon", "LightBlue", "LightCoral", "LightCyan",
    "LightGoldenRodYellow", "LightGray", "LightGrey", "LightGreen",
    "LightPink", "LightSalmon", "LightSeaGreen", "LightSkyBlue",
    "LightSlateGray", "LightSlateGrey", "LightSteelBlue", "LightYellow",
    "Lime", "LimeGreen", "Linen", "Magenta", "MediumAquaMarine",
    "MediumOrchid", "MediumPurple", "MediumSeaGreen", "MediumSlateBlue",
    "MediumSpringGreen", "MediumTurquoise", "MediumVioletRed", "MintCream",
    "MistyRose", "Moccasin", "NavajoWhite", "OldLace", "Olive", "OliveDrab",
    "Orange", "OrangeRed", "Orchid", "PaleGoldenRod", "PaleGreen",
    "PaleTurquoise", "PaleVioletRed", "PapayaWhip", "PeachPuff", "Peru",
    "Pink", "Plum", "PowderBlue", "Purple", "Red", "RosyBrown", "RoyalBlue",
    "SaddleBrown", "Green", "SandyBrown", "SeaGreen", "SeaShell", "Sienna",
    "Silver", "SkyBlue", "SlateBlue", "SlateGray", "SlateGrey", "Snow",
    "SpringGreen", "SteelBlue", "GreenYellow", "Teal", "Thistle", "Tomato",
    "Turquoise", "Violet", "Wheat", "White", "WhiteSmoke", "Yellow",
    "YellowGreen",
]


def draw_bounding_box_on_image(image: Image.Image, ymin, xmin, ymax, xmax,
                               color="red", thickness=4,
                               display_str_list=(),
                               use_normalized_coordinates=True):
    draw = ImageDraw.Draw(image)
    im_width, im_height = image.size
    if use_normalized_coordinates:
        left, right = xmin * im_width, xmax * im_width
        top, bottom = ymin * im_height, ymax * im_height
    else:
        left, right, top, bottom = xmin, xmax, ymin, ymax
    draw.line([(left, top), (left, bottom), (right, bottom), (right, top),
               (left, top)], width=thickness, fill=color)
    # stacked label strips above (or below) the box
    text_bottom = top
    for display_str in display_str_list[::-1]:
        bbox = draw.textbbox((0, 0), display_str)
        text_width = bbox[2] - bbox[0]
        text_height = bbox[3] - bbox[1]
        margin = int(np.ceil(0.05 * text_height))
        if text_bottom - text_height - 2 * margin < 0:
            text_bottom = bottom + text_height + 2 * margin
        draw.rectangle(
            [(left, text_bottom - text_height - 2 * margin),
             (left + text_width + 2 * margin, text_bottom)],
            fill=color)
        draw.text((left + margin, text_bottom - text_height - margin),
                  display_str, fill="black")
        text_bottom -= text_height + 2 * margin


def draw_bounding_box_on_image_array(image: np.ndarray, ymin, xmin, ymax,
                                     xmax, color="red", thickness=4,
                                     display_str_list=(),
                                     use_normalized_coordinates=True):
    pil = Image.fromarray(np.uint8(image)).convert("RGB")
    draw_bounding_box_on_image(pil, ymin, xmin, ymax, xmax, color, thickness,
                               display_str_list, use_normalized_coordinates)
    np.copyto(image, np.array(pil))


def draw_bounding_boxes_on_image_array(image: np.ndarray, boxes: np.ndarray,
                                       color="red", thickness=4,
                                       display_str_list_list=()):
    """boxes: (N, 4) [ymin, xmin, ymax, xmax] normalized."""
    for i in range(boxes.shape[0]):
        strs = (display_str_list_list[i]
                if i < len(display_str_list_list) else ())
        draw_bounding_box_on_image_array(
            image, boxes[i, 0], boxes[i, 1], boxes[i, 2], boxes[i, 3],
            color, thickness, strs)


def draw_keypoints_on_image_array(image: np.ndarray, keypoints,
                                  color="red", radius=2,
                                  use_normalized_coordinates=True):
    pil = Image.fromarray(np.uint8(image)).convert("RGB")
    draw = ImageDraw.Draw(pil)
    im_width, im_height = pil.size
    for y, x in keypoints:
        if use_normalized_coordinates:
            x, y = x * im_width, y * im_height
        draw.ellipse([(x - radius, y - radius), (x + radius, y + radius)],
                     outline=color, fill=color)
    np.copyto(image, np.array(pil))


def draw_mask_on_image_array(image: np.ndarray, mask: np.ndarray,
                             color="red", alpha=0.4):
    """Alpha-blend a binary (H, W) mask onto an RGB uint8 array."""
    rgb = np.asarray(Image.new("RGB", (1, 1), color), np.float64)[0, 0]
    solid = np.zeros_like(image, np.float64)
    solid[..., :] = rgb
    m = (mask > 0)[..., None].astype(np.float64) * alpha
    blended = image.astype(np.float64) * (1 - m) + solid * m
    np.copyto(image, blended.astype(np.uint8))


def visualize_boxes_and_labels_on_image_array(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: Sequence[int],
    scores: Optional[Sequence[float]],
    category_index: Dict[int, Dict],
    instance_masks: Optional[Sequence[np.ndarray]] = None,
    keypoints: Optional[Sequence] = None,
    use_normalized_coordinates=False,
    max_boxes_to_draw=20,
    min_score_thresh=0.5,
    agnostic_mode=False,
    line_thickness=4,
):
    """Top-level orchestration (`visualize/vis_utils.py` equivalent)."""
    box_to_strs = collections.defaultdict(list)
    box_to_color = collections.defaultdict(str)
    box_to_mask = {}
    box_to_keypoints = collections.defaultdict(list)
    n = min(max_boxes_to_draw or boxes.shape[0], boxes.shape[0])
    for i in range(n):
        if scores is not None and scores[i] < min_score_thresh:
            continue
        box = tuple(boxes[i].tolist())
        if instance_masks is not None:
            box_to_mask[box] = instance_masks[i]
        if keypoints is not None:
            box_to_keypoints[box].extend(keypoints[i])
        if scores is None:
            box_to_color[box] = "black"
            box_to_strs[box] = []
        else:
            if agnostic_mode:
                display_str = f"score: {int(100 * scores[i])}%"
            else:
                cid = int(classes[i])
                name = category_index.get(cid, {}).get("name", "N/A")
                display_str = f"{name}: {int(100 * scores[i])}%"
            box_to_strs[box] = [display_str]
            if agnostic_mode:
                box_to_color[box] = "DarkOrange"
            else:
                box_to_color[box] = STANDARD_COLORS[
                    int(classes[i]) % len(STANDARD_COLORS)]
    for box, color in box_to_color.items():
        ymin, xmin, ymax, xmax = box
        if box in box_to_mask:
            draw_mask_on_image_array(image, box_to_mask[box], color)
        draw_bounding_box_on_image_array(
            image, ymin, xmin, ymax, xmax, color, line_thickness,
            box_to_strs[box], use_normalized_coordinates)
        if box_to_keypoints[box]:
            draw_keypoints_on_image_array(
                image, box_to_keypoints[box], color,
                use_normalized_coordinates=use_normalized_coordinates)
    return image
