"""Learning-rate and loss-EMA schedules.

Port of ``tmv_tpu/core/schedules.py``, computed in float32 on the host (numpy)
as the JAX package computes them in float32 on the device:

- ``shadow_loss_decay``: the YOLO shadow-loss decay ramp
  ``min(loss_decay, (1 + step) / (1000 + step))`` (`yolo_v3/model.py:205-207`);
- ``cosine_lr_schedule``: linear warmup, then ``0.5·lr·(1 + cos(π·step /
  decay_steps))`` on the *raw* step (the reference's quirk,
  `efficientnet/train.py:35-63`);
- ``scaled_lr``: linear batch-size scaling.
"""

import math

import numpy as np


def shadow_loss_decay(step, loss_decay: float = 0.9) -> np.float32:
    step_f = np.float32(step)
    return np.minimum(np.float32(loss_decay),
                      (np.float32(1.0) + step_f) / (np.float32(1000.0) + step_f))


def cosine_lr_schedule(adjusted_lr: float, lr_warmup_init: float, lr_warmup_step: int,
                       total_steps: int):
    """The reference's cosine schedule with linear warmup: ``step -> lr``."""
    decay_steps = np.float32(total_steps - lr_warmup_step)
    lr, init = np.float32(adjusted_lr), np.float32(lr_warmup_init)

    def schedule(step) -> np.float32:
        step_f = np.float32(step)
        if step < lr_warmup_step:
            return init + step_f / np.float32(lr_warmup_step) * (lr - init)
        return np.float32(0.5) * lr * (np.float32(1) + np.cos(np.float32(math.pi) * step_f
                                                              / decay_steps))

    return schedule


def scaled_lr(base_lr: float, batch_size: int, base_batch: int = 64) -> float:
    """Linear batch-size LR scaling (`efficientnet/train.py:106`)."""
    return base_lr * batch_size / base_batch
