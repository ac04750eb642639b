"""EfficientDet multiscale anchors: generation, training targets and the decode.

Port of ``tmv_tpu/ops/anchors.py``: ``get_feat_sizes``, the ``Anchors`` boxes
(numpy, yxyx pixels), ``generate_targets`` / ``_boxes_encoder``,
``convert_outputs_boxes`` / ``_boxes_decoder`` and ``convert_outputs_one``.
Both batched functions take a leading image axis where the JAX functions are
vmapped or take a ``batch_index``: ``generate_targets`` scores every anchor of a
level against every padded GT box of every image at once (IoU ``(B, h·w·A,
max_boxes)``), and the B images' candidates go to one NMS launch. The semantics
are the reference's:

- anchors whose argmax class is 0 (background) get a score of -inf;
- the top ``pre_nms_size`` (1024) candidates by raw class logit enter NMS;
- NMS drops candidates whose **raw logit** is below ``score_threshold`` (1e-4),
  not the sigmoid (a quirk of the reference, kept);
- the kept scores are sigmoided.

The top-k is a stable descending sort, so ties keep the lower index first as
``jax.lax.top_k`` does, and ``torch.argmax`` takes the first maximum as
``jnp.argmax`` does (the targets' GT assignment too). A target anchor is
positive where its best IoU is ≥ 0.5; padded GTs score −1.
"""

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from tmv_tpu_torch.ops.iou import iou_yxyx
from tmv_tpu_torch.ops.nms import nms
from tmv_tpu_torch.ops.yolo import gather_rows

EPSILON = 1e-8


def get_feat_sizes(image_size: Tuple[int, int], max_level: int) -> List[Tuple[int, int]]:
    """Per-level feature sizes: level 0 = image, then ``(s - 1) // 2 + 1``."""
    feat_size = (int(image_size[0]), int(image_size[1]))
    sizes = [feat_size]
    for _ in range(1, max_level + 1):
        feat_size = ((feat_size[0] - 1) // 2 + 1, (feat_size[1] - 1) // 2 + 1)
        sizes.append(feat_size)
    return sizes


class Anchors:
    """Multiscale anchor boxes (yxyx, pixels) and the output decode."""

    def __init__(
        self,
        min_level: int,
        max_level: int,
        image_size: Tuple[int, int],
        num_scales: int,
        aspect_ratios: Sequence[Tuple[float, float]],
        anchor_scale: Union[float, Sequence[float]],
    ):
        self.min_level = min_level
        self.max_level = max_level
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.num_scales = num_scales
        self.aspect_ratios = list(aspect_ratios)
        if isinstance(anchor_scale, (list, tuple)):
            assert len(anchor_scale) == max_level - min_level + 1
            self.anchor_scales = list(anchor_scale)
        else:
            self.anchor_scales = [anchor_scale] * (max_level - min_level + 1)
        self.feat_sizes = get_feat_sizes(self.image_size, max_level)
        # list over levels of (h, w, A, 4) float32 numpy arrays
        self.boxes: List[np.ndarray] = self._generate_boxes()
        self._on_device: Dict[torch.device, List[torch.Tensor]] = {}

    def _generate_boxes(self) -> List[np.ndarray]:
        boxes_all = []
        fs = self.feat_sizes
        for level in range(self.min_level, self.max_level + 1):
            stride = (fs[0][0] / float(fs[level][0]), fs[0][1] / float(fs[level][1]))
            anchor_scale = self.anchor_scales[level - self.min_level]
            boxes_level = []
            for scale_octave in range(self.num_scales):
                octave_scale = scale_octave / float(self.num_scales)
                for aspect in self.aspect_ratios:
                    base_x = anchor_scale * stride[1] * 2**octave_scale
                    base_y = anchor_scale * stride[0] * 2**octave_scale
                    half_x = base_x * aspect[1] / 2.0
                    half_y = base_y * aspect[0] / 2.0
                    x = np.arange(stride[1] / 2, self.image_size[1], stride[1])
                    y = np.arange(stride[0] / 2, self.image_size[0], stride[0])
                    xv, yv = np.meshgrid(x, y)
                    boxes = np.stack(
                        [yv - half_y, xv - half_x, yv + half_y, xv + half_x],
                        axis=-1,
                    )  # (h, w, 4)
                    boxes_level.append(boxes[:, :, None, :])
            boxes_all.append(
                np.concatenate(boxes_level, axis=-2).astype(np.float32)
            )
        return boxes_all

    def get_anchors_per_location(self) -> int:
        return self.num_scales * len(self.aspect_ratios)

    def boxes_on(self, device) -> List[torch.Tensor]:
        """The anchor boxes as float32 tensors on ``device`` (copied once)."""
        device = torch.device(device)
        if torch.compiler.is_exporting():
            # made inside the traced program: a cached copy would be a traced tensor
            return [torch.from_numpy(b).to(device) for b in self.boxes]
        if device not in self._on_device:
            self._on_device[device] = [torch.from_numpy(b).to(device) for b in self.boxes]
        return self._on_device[device]

    # ------------------------------------------------------------------ targets
    def generate_targets(self, boxes: torch.Tensor, classes: torch.Tensor, classes_num: int,
                         valid: torch.Tensor, iou_threshold: float = 0.5):
        """Assign padded GT boxes to anchors, per level, for a batch of images.

        Args:
            boxes: ``(B, max_boxes, 4)`` float32 yxyx pixel GT boxes.
            classes: ``(B, max_boxes)`` int class ids (0 = background).
            valid: ``(B, max_boxes)`` bool padding mask.

        Returns ``(boxes_t, classes_t, masks_t)``: tuples over levels of ``(B, h,
        w, A, 4)`` encoded float32 targets (0 on negatives), ``(B, h, w, A,
        classes_num)`` float32 one-hot classes (background on negatives) and
        ``(B, h, w, A, 1)`` bool positive masks, on the boxes' device.
        """
        b = boxes.shape[0]
        out_boxes, out_classes, out_mask = [], [], []
        for anchor_level in self.boxes_on(boxes.device):
            shape = anchor_level.shape[:-1]
            anchors = anchor_level.reshape(-1, 4)                                 # (N, 4)
            iou = iou_yxyx(anchors[None, :, None, :], boxes[:, None, :, :])       # (B, N, M)
            iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
            iou_max = torch.amax(iou, dim=-1)
            iou_index = torch.argmax(iou, dim=-1)                       # the first maximum
            mask = (iou_max >= iou_threshold)[..., None]                          # (B, N, 1)
            boxes_level = self._boxes_encoder(anchors, gather_rows(boxes, iou_index))
            boxes_level = torch.where(mask, boxes_level, torch.zeros_like(boxes_level))
            classes_level = torch.gather(classes.long(), 1, iou_index)
            classes_level = torch.where(mask[..., 0], classes_level,
                                        torch.zeros_like(classes_level))
            onehot = torch.nn.functional.one_hot(classes_level, classes_num).to(torch.float32)
            out_boxes.append(boxes_level.reshape(b, *shape, 4))
            out_classes.append(onehot.reshape(b, *shape, classes_num))
            out_mask.append(mask.reshape(b, *shape, 1))
        return tuple(out_boxes), tuple(out_classes), tuple(out_mask)

    # ------------------------------------------------------------------ decode
    def convert_outputs_boxes(self, outputs_boxes):
        """Decode per-level ``(B, h, w, A, 4)`` regressions to yxyx boxes."""
        anchors = self.boxes_on(outputs_boxes[0].device)
        return tuple(self._boxes_decoder(a, r) for a, r in zip(anchors, outputs_boxes))

    def convert_outputs_one(
        self,
        outputs_boxes,
        outputs_classes,
        max_output_size: int = 200,
        iou_threshold: float = 0.5,
        score_threshold: float = 0.0001,
        iou_type: str = "diou",
        pre_nms_size: int = 1024,
    ):
        """Decode → background filter → DIoU-NMS → sigmoid scores, per image.

        Args:
            outputs_boxes: per-level ``(B, h, w, A, 4)`` decoded yxyx boxes.
            outputs_classes: per-level ``(B, h, w, A, C)`` class logits.

        Returns (boxes, classes_id, scores, valid), each with a leading image
        axis and padded to ``max_output_size``.
        """
        b = outputs_classes[0].shape[0]
        all_boxes, all_ids, all_scores = [], [], []
        for boxes_level, cls_logits in zip(outputs_boxes, outputs_classes):
            cls_logits = cls_logits.reshape(b, -1, cls_logits.shape[-1])
            classes_scores = torch.amax(cls_logits, dim=-1)
            # argmax returns the first maximum, as jnp.argmax does
            classes_id = torch.argmax(cls_logits, dim=-1)
            fg = classes_id != 0
            classes_scores = torch.where(fg, classes_scores,
                                         torch.full_like(classes_scores, float("-inf")))
            all_boxes.append(boxes_level.reshape(b, -1, 4))
            all_ids.append(classes_id.to(torch.int32))
            all_scores.append(classes_scores)
        boxes_cat = torch.cat(all_boxes, dim=1)
        ids_cat = torch.cat(all_ids, dim=1)
        scores_cat = torch.cat(all_scores, dim=1)
        k = min(pre_nms_size, scores_cat.shape[1])
        cand = torch.sort(scores_cat, dim=-1, descending=True, stable=True).indices[:, :k]
        idx, valid = nms(
            gather_rows(boxes_cat, cand),
            gather_rows(scores_cat, cand),
            max_output_size=max_output_size,
            iou_threshold=iou_threshold,
            score_threshold=score_threshold,
            iou_type=iou_type,
            coord="yxyx",
        )
        sel = torch.gather(cand, 1, idx.long())
        return (gather_rows(boxes_cat, sel), gather_rows(ids_cat, sel),
                torch.sigmoid(gather_rows(scores_cat, sel)), valid)

    # ------------------------------------------------------------------ codecs
    @staticmethod
    def _center_sizes(boxes):
        ycenter = (boxes[..., 2] + boxes[..., 0]) / 2.0
        xcenter = (boxes[..., 3] + boxes[..., 1]) / 2.0
        h = boxes[..., 2] - boxes[..., 0]
        w = boxes[..., 3] - boxes[..., 1]
        return ycenter, xcenter, h, w

    def _boxes_encoder(self, anchors, boxes):
        """yxyx boxes → (ty, tx, th, tw) relative to anchors."""
        ycenter_a, xcenter_a, ha, wa = self._center_sizes(anchors)
        ycenter, xcenter, h, w = self._center_sizes(boxes)
        ha = torch.clamp_min(ha, EPSILON)
        wa = torch.clamp_min(wa, EPSILON)
        h = torch.clamp_min(h, EPSILON)
        w = torch.clamp_min(w, EPSILON)
        tx = (xcenter - xcenter_a) / wa
        ty = (ycenter - ycenter_a) / ha
        tw = torch.log(w / wa)
        th = torch.log(h / ha)
        return torch.stack([ty, tx, th, tw], dim=-1)

    def _boxes_decoder(self, anchors, rel_codes):
        """(ty, tx, th, tw) → yxyx boxes."""
        ycenter_a, xcenter_a, ha, wa = self._center_sizes(anchors)
        ty, tx, th, tw = rel_codes.unbind(-1)
        w = torch.exp(tw) * wa
        h = torch.exp(th) * ha
        ycenter = ty * ha + ycenter_a
        xcenter = tx * wa + xcenter_a
        return torch.stack(
            [ycenter - h / 2.0, xcenter - w / 2.0, ycenter + h / 2.0,
             xcenter + w / 2.0],
            dim=-1,
        )
