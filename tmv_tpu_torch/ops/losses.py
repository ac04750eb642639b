"""Losses of the port's training paths.

Port of ``tmv_tpu/ops/losses.py``, so far only ``sigmoid_cross_entropy`` (the
YOLO loss's). Focal, Huber and the rest come with the EfficientDet-D0 and
FaceNet training slices.
"""

import torch


def sigmoid_cross_entropy(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid CE, numerically stable (tf.nn semantics).

    At ``logits == 0`` the gradient is JAX's: ``torch.maximum`` splits it in
    halves as ``jnp.maximum`` does, and ``|x|`` is written as a ``where`` whose
    slope at 0 is 1, as ``jnp.abs``'s is (``Tensor.abs`` has slope 0 there)."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_logits)))
