"""Losses of the port's training paths.

Port of ``tmv_tpu/ops/losses.py``: ``sigmoid_cross_entropy`` (the YOLO loss's)
and EfficientDet's ``focal_loss``, ``huber``, ``box_loss``, ``class_focal_loss``
and ``l2_regularization``, the UNet family's ``focus_loss``, FaceNet's
``euclidean_distance_sq`` and ``triplet_loss``, MoCo's ``moco_info_nce_loss``
and the dormant ``smooth_l1_loss``, in the JAX package's operation order.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tmv_tpu_torch.parallel.collectives import global_sum, is_sharded, whole, world


def sigmoid_cross_entropy(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid CE, numerically stable (tf.nn semantics).

    At ``logits == 0`` the gradient is JAX's: ``torch.maximum`` splits it in
    halves as ``jnp.maximum`` does, and ``|x|`` is written as a ``where`` whose
    slope at 0 is 1, as ``jnp.abs``'s is (``Tensor.abs`` has slope 0 there)."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_logits)))


def focal_loss(y_true: torch.Tensor, y_pred_logits: torch.Tensor, normalizer,
               alpha: float = 0.25, gamma: float = 1.5,
               label_smoothing: float = 0.0) -> torch.Tensor:
    """Elementwise α/γ sigmoid focal loss divided by ``normalizer``; the
    modulating factors use the unsmoothed labels. The caller reduces."""
    pred_prob = torch.sigmoid(y_pred_logits)
    p_t = y_true * pred_prob + (1 - y_true) * (1 - pred_prob)
    alpha_factor = y_true * alpha + (1 - y_true) * (1 - alpha)
    modulating_factor = (1.0 - p_t) ** gamma
    y_smooth = y_true * (1.0 - label_smoothing) + 0.5 * label_smoothing
    ce = sigmoid_cross_entropy(y_smooth, y_pred_logits)
    return alpha_factor * modulating_factor * ce / normalizer


def huber(y_true: torch.Tensor, y_pred: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise Huber loss: quadratic below ``delta``, linear above."""
    err = y_pred - y_true
    abs_err = torch.abs(err)
    return torch.where(abs_err <= delta, 0.5 * torch.square(err),
                       delta * abs_err - 0.5 * delta**2)


def box_loss(box_targets: torch.Tensor, box_outputs: torch.Tensor, num_positives,
             delta: float = 0.1) -> torch.Tensor:
    """Huber box regression over the nonzero targets / (4 · num_positives). The
    mask is elementwise ``box_targets != 0``, as in the reference: a positive's
    coordinate that encodes to exactly 0 drops out too."""
    normalizer = num_positives * 4.0
    mask = (box_targets != 0.0).to(box_outputs.dtype)
    return torch.sum(huber(box_targets, box_outputs, delta) * mask) / normalizer


def class_focal_loss(class_targets: Sequence[torch.Tensor],
                     class_outputs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                     alpha: float, gamma: float, label_smoothing: float = 0.0) -> torch.Tensor:
    """Multi-level focal loss, each level's sum divided by its positives per
    image (``sum(mask) / batch``), a level without positives adding 0. In a
    data-parallel step the positives are the global batch's and a rank's sum is
    scaled by R (``parallel.collectives``)."""
    total = 0.0
    ranks = world()
    for targets, outputs, mask in zip(class_targets, class_outputs, masks):
        normalizer = global_sum(torch.sum(mask.to(torch.float32))) / float(mask.shape[0] * ranks)
        per_elem = focal_loss(targets, outputs, 1.0, alpha=alpha, gamma=gamma,
                              label_smoothing=label_smoothing)
        safe = torch.where(normalizer == 0, torch.ones_like(normalizer), normalizer)
        total = total + torch.where(normalizer == 0, torch.zeros_like(normalizer),
                                    torch.sum(per_elem) * ranks / safe)
    return total


def regularized_weights(model: nn.Module):
    """The conv and dense kernels of ``model``: the leaves the JAX package's
    ``l2_regularization`` selects by name (``kernel``) in the flax tree. In torch
    a BatchNorm's scale is also named ``weight``, so the selection is by module
    type: no BatchNorm scale, no bias, no BiFPN ``WSM`` weight."""
    return [m.weight for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]


def l2_regularization(model: nn.Module, weight_decay: float) -> torch.Tensor:
    """``weight_decay · Σ w²`` over ``regularized_weights(model)``. Weights that FSDP
    shards (``DTensor``) are summed apart, their sum made whole (``full_tensor``, one
    all-reduce) before it joins the others'."""
    total = 0.0
    weights = regularized_weights(model)
    for sharded in (False, True):
        part = sum(torch.sum(torch.square(w)) for w in weights if is_sharded(w) == sharded)
        total = total + whole(part)
    return weight_decay * total


def focus_loss(y_true: torch.Tensor, y_pred_logits: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """Balanced MSE for keypoint heatmaps (`losses/focus_loss.py:10-39`): the
    foreground (nonzero-target) and background pixels normalized apart by
    their counts and inverse frequency, divided by the batch. ``threshold`` is
    unused, as in the JAX function."""
    b, h, w = y_true.shape[0], y_true.shape[1], y_true.shape[2]
    y_pred = torch.sigmoid(y_pred_logits)
    object_mask = (y_true != 0.0).to(y_pred.dtype)
    object_num = torch.sum(object_mask)
    hw = float(h * w)
    other_num = hw - object_num
    object_percent = object_num / hw
    sq_obj = torch.sum(torch.square((y_true - y_pred) * object_mask))
    sq_other = torch.sum(torch.square((y_true - y_pred) * (1.0 - object_mask)))
    loss_object = sq_obj / object_num / object_percent
    loss_other = sq_other / other_num / (1.0 - object_percent)
    return (loss_object + loss_other) / float(b)


def smooth_l1_loss(y_true: torch.Tensor, y_pred: torch.Tensor, beta: float = 0.5) -> torch.Tensor:
    """β-smooth-L1, elementwise (`utils/smooth_l1_loss.py:10-14`)."""
    a = torch.abs(y_pred - y_true)
    return torch.where(a < beta, 0.5 * a ** 2 / beta, a - 0.5 * beta)


def euclidean_distance_sq(e1: torch.Tensor, e2: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Squared euclidean distance (`facenet_model.py:112-122`)."""
    return torch.sum(torch.square(e1 - e2), dim=axis)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 alpha: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``max(pos − neg + α, 0)`` over squared distances, the mean over the batch;
    with ``valid``, the sum over the valid triplets / ``max(Σ valid, 1)``, the count
    over the global batch in a data-parallel step (a rank's sum scaled by R).
    ``torch.maximum`` splits the gradient at a hinge of exactly 0 in halves, as
    ``jnp.maximum`` does."""
    pos_dist = euclidean_distance_sq(anchor, positive, axis=1)
    neg_dist = euclidean_distance_sq(anchor, negative, axis=1)
    hinge = pos_dist - neg_dist + alpha
    basic = torch.maximum(hinge, torch.zeros_like(hinge))
    if valid is None:
        return torch.mean(basic)
    valid_f = valid.to(basic.dtype)
    return (torch.sum(basic * valid_f) * world()
            / torch.clamp(global_sum(torch.sum(valid_f)), min=1.0))


def flatten_heads(heads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(N, D)``: each head ``(N, h, w, c)`` flattened in NHWC logical order
    (``reshape`` of the NHWC view, whatever its memory layout), the scales
    concatenated in order, as ``jnp.reshape`` flattens JAX's NHWC heads."""
    n = heads[0].shape[0]
    return torch.cat([h.reshape(n, -1) for h in heads], dim=-1)


def l2_normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """``x / ‖x‖₂`` per row (no epsilon, as JAX divides)."""
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def moco_info_nce_loss(y_q: Sequence[torch.Tensor], y_k: Sequence[torch.Tensor],
                       queue: torch.Tensor, temperature: float = 0.07) -> torch.Tensor:
    """MoCo InfoNCE over l2-normalised flattened multi-scale features
    (`momentum_contrast/model.py:316-348`): ``l_pos = q·k`` per sample, ``l_neg
    = q @ queueᵀ`` over the K queued keys, ``−log_softmax(logits / T)[:, 0]``
    averaged over the batch. The heads are NHWC (the port's towers return an
    NHWC view of their ``channels_last`` output)."""
    q = l2_normalize_rows(flatten_heads(y_q))
    k = l2_normalize_rows(flatten_heads(y_k))
    l_pos = torch.sum(q * k, dim=1, keepdim=True)
    l_neg = q @ queue.T
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return torch.mean(-torch.log_softmax(logits, dim=1)[:, 0])
