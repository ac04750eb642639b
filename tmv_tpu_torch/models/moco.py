"""MoCo momentum-contrast pretraining on the ResNetV2-YOLO tower.

Port of ``tmv_tpu/models/moco.py`` (the reference's
`momentum_contrast/model.py`):

- ``ResNetYoloV3``: the ResNet50V2 taps under YOLOv3's neck and heads, the
  query and key towers of MoCo and the student/teacher of distillation;
- ``MocoState``: the key tower, the ``(K, D)`` queue of l2-normalised keys and
  its pointer (JAX's ``TrainState.extra``). The key tower is a live module, as
  the port's ``TrainState`` holds the query tower; ``state_dict`` /
  ``load_state_dict`` let ``core/checkpoint.py`` save and restore all three
  beside the query state;
- ``push_queue``: the ring-buffer enqueue (`model.py:305-314`);
- ``make_moco_train_step``: the key forward in eval mode without a graph, the
  query's InfoNCE step, then the momentum update of the key tower with the
  warm-up decay ``min(momentum, step / warmup)`` read at the step count before
  the increment, and the enqueue of the keys.
"""

import copy
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.core.train_state import forward_module
from tmv_tpu_torch.models.backbones.resnet_v2 import ResNet50V2
from tmv_tpu_torch.models.yolo_v3 import add_heads, heads_forward
from tmv_tpu_torch.ops.losses import flatten_heads, l2_normalize_rows, moco_info_nce_loss
from tmv_tpu_torch.parallel.collectives import all_gather_rows, mean_over_ranks


class ResNetYoloV3(nn.Module):
    """ResNet50V2 backbone + YOLOv3 neck/heads: NHWC image → (h1, h2, h3) NHWC
    raw heads of ``out_filters`` channels at strides 32/16/8. ``dtype`` and
    ``param_dtype`` are those of ``yolo_v4.YoloV4``; ``remat`` runs ResNet50V2's
    blocks and the three ``LastLayers`` under ``layers.common.remat_call``."""

    def __init__(self, out_filters: int, dtype: torch.dtype = torch.float32, device=None,
                 param_dtype=None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        kw = dict(dtype=param_dtype or dtype, device=device)
        self.ResNet50V2_0 = ResNet50V2(remat=remat, **kw)
        add_heads(self, (2048, 1024, 512), out_filters, **kw)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        return heads_forward(self, *self.ResNet50V2_0(x), remat=self.remat)


def flatten_normalize(heads) -> torch.Tensor:
    """The heads flattened in NHWC order and l2-normalised per sample."""
    return l2_normalize_rows(flatten_heads(heads))


@dataclass
class MocoState:
    """The key tower, the queue of keys and the queue's write pointer."""

    key_model: nn.Module
    queue: torch.Tensor   # (K, D) float32, l2-normalised rows
    queue_ptr: int = 0

    def state_dict(self) -> Dict:
        return {"key_model": self.key_model.state_dict(), "queue": self.queue,
                "queue_ptr": self.queue_ptr}

    def load_state_dict(self, state: Dict):
        self.key_model.load_state_dict(state["key_model"], strict=True)
        self.queue.copy_(state["queue"])
        self.queue_ptr = int(state["queue_ptr"])


def init_moco_state(model: nn.Module, queue_size: int, feature_dim: int,
                    generator: Optional[torch.Generator] = None,
                    queue: Optional[np.ndarray] = None) -> MocoState:
    """The key tower as a copy of the query tower ``model`` (JAX initialises
    both from one set of variables) and the queue: ``queue`` where given (JAX's),
    else ``queue_size × feature_dim`` uniform [0, 1) draws from ``generator`` on
    the model's device, each row l2-normalised (`model.py:78-87`)."""
    device = next(model.parameters()).device
    key_model = copy.deepcopy(model)
    for p in key_model.parameters():
        p.requires_grad_(False)
    if queue is None:
        draws = torch.rand((queue_size, feature_dim), generator=generator, device=device)
        queue = l2_normalize_rows(draws)
    else:
        queue = torch.as_tensor(np.asarray(queue), dtype=torch.float32, device=device)
        if tuple(queue.shape) != (queue_size, feature_dim):
            raise ValueError(f"queue of shape {tuple(queue.shape)}, expected "
                             f"{(queue_size, feature_dim)}")
    return MocoState(key_model, queue.contiguous(), 0)


def push_queue(queue: torch.Tensor, ptr: int, items: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Write ``items`` (n ≤ K rows) into ``queue`` at rows ``(ptr + i) % K``, in
    place; returns the queue and the new pointer ``(ptr + n) % K``."""
    k, n = queue.shape[0], items.shape[0]
    if n > k:
        raise ValueError(f"{n} keys do not fit a queue of {k}")
    idx = (ptr + torch.arange(n, device=queue.device)) % k
    queue.index_copy_(0, idx, items.to(queue.dtype))
    return queue, (ptr + n) % k


def _float_tensors(module: nn.Module):
    """The parameters, then the floating buffers (the BatchNorm statistics, not
    the step counters), in module order."""
    return ([p for p in module.parameters()]
            + [b for b in module.buffers() if b.is_floating_point()])


def momentum_update(key_model: nn.Module, model: nn.Module, step: int, momentum: float,
                    warmup_steps: int):
    """``k = k·decay + q·(1 − decay)`` over the parameters and BatchNorm
    statistics, ``decay = min(momentum, step / warmup_steps)`` in float32 as
    the JAX step computes it (`model.py:141-151`)."""
    decay = np.minimum(np.float32(momentum), np.float32(step) / np.float32(warmup_steps))
    keys = _float_tensors(key_model)
    with torch.no_grad():
        torch._foreach_mul_(keys, float(decay))
        torch._foreach_add_(keys, [q.detach() for q in _float_tensors(model)],
                            alpha=float(np.float32(1) - decay))


def make_moco_train_step(temperature: float = 0.07, momentum: float = 0.999,
                         momentum_warmup_steps: int = 1000):
    """Build ``train_step(state, batch) -> metrics`` for a ``TrainState`` whose
    ``extra`` is a ``MocoState`` and whose optimizer is ``torch.optim.SGD(lr,
    momentum=0.9)`` (``optax.sgd(lr, momentum=0.9)``); ``batch`` holds NHWC
    ``query`` and ``key`` images. The step updates the state in place: the key
    forward (eval mode, its own BatchNorm statistics, no graph), the query's
    train-mode forward and InfoNCE loss against the queue, the SGD step, the
    momentum update of the key tower and the enqueue of the keys. No shadow loss.
    Returns ``{"loss"}`` as a device tensor. Under ``parallel.train.DataParallel``
    the query runs through DDP, the loss reported is the global batch's and the
    queue takes the keys of the global batch in rank order."""

    def train_step(state, batch) -> Dict[str, torch.Tensor]:
        moco: MocoState = state.extra
        model, optimizer = state.model, state.optimizer
        moco.key_model.eval()
        with torch.no_grad():
            y_k = moco.key_model(batch["key"])
        model.train()
        optimizer.zero_grad(set_to_none=True)
        y_q = forward_module(state)(batch["query"])
        loss = moco_info_nce_loss(y_q, y_k, moco.queue, temperature)
        loss.backward()
        if state.parallel is not None:
            state.parallel.finish_grads(state)
        optimizer.step()
        momentum_update(moco.key_model, model, state.step, momentum, momentum_warmup_steps)
        # a data-parallel step enqueues the keys of the global batch in rank order
        moco.queue, moco.queue_ptr = push_queue(moco.queue, moco.queue_ptr,
                                                all_gather_rows(flatten_normalize(y_k)))
        state.step += 1
        return {"loss": mean_over_ranks(loss)}

    return train_step
