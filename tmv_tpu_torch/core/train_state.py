"""Train state and the train step.

Port of ``tmv_tpu/core/train_state.py::TrainState`` and ``make_train_step``. The
JAX package threads a functional state through a jitted step; here the state
holds the live module (its parameters and BatchNorm buffers) and its
``torch.optim`` optimizer, and the step updates them in place:

- the *shadow loss* (`yolo_v3/model.py:205-210`): after ``step > 1`` the
  gradients are scaled by ``1 − decay`` and the reported loss is the blend
  ``scale·loss + decay·shadow``; the raw loss is reported beside it;
- an optional global-norm clip (``optax.clip_by_global_norm`` semantics);
- an optional weight EMA (tfa ``MovingAverage``), with an optional EMA of the
  BatchNorm statistics;
- gradient accumulation: the batch splits into ``accum_steps`` micro-batches
  whose gradients are averaged before one update, the BatchNorm statistics
  threaded through the micro-batches in order;
- data parallelism: a state placed by ``parallel.train.DataParallel`` or
  ``parallel.fsdp.FullyShardedDataParallel`` (``state.parallel``) runs the loss
  through that wrapper's module (DDP's, whose hooks average the gradients over the
  ranks, or the FSDP-sharded one), and its step runs inside the wrapper's data group,
  so the batch reductions below it are the global batch's. The reported ``loss``,
  ``raw_loss``, the aux metrics and the shadow loss are means over the ranks, the
  same on every rank; the clip's ``gnorm`` is read after the gradient reduction.
  With ``accum_steps > 1`` a rank's batch holds its rows of each global
  micro-batch in order (``parallel.mesh.shard_batch``), so micro-batch i is its
  share of the one-device step's micro-batch i, and only the last micro-batch's
  backward reduces the gradients.

``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` is ``optax.adam``'s update,
``torch.optim.SGD(momentum=0.9)`` (no dampening, no Nesterov) is
``optax.sgd(schedule, momentum=0.9)``'s and ``torch.optim.Adadelta(lr, rho=0.9,
eps=1e-6)`` is ``optax.adadelta(lr)``'s. Two optax rules have no torch
counterpart and are written here: ``OptaxRMSprop`` (``optax.rmsprop`` adds eps
inside the square root, torch's ``RMSprop`` outside) and ``OptaxAdagrad``
(``optax.adagrad`` starts its accumulator at 0.1 and adds eps inside the square
root; torch's starts at 0 and adds it outside). A ``lr_schedule`` is read at the
step count before the update, as optax reads its schedule, and set into the
optimizer's ``param_groups`` before it steps.

``make_line_search_train_step`` is the reference's experimental "dynamic
learning rate" step (off by default there): plain SGD along the clipped
gradient, the learning rate shrunk until the loss improves.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tmv_tpu_torch.core.schedules import shadow_loss_decay
from tmv_tpu_torch.parallel.collectives import is_sharded, mean_over_ranks, whole


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    shadow_loss: Optional[torch.Tensor] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    extra: Optional[Any] = None   # family state with state_dict/load_state_dict (MoCo's)
    parallel: Optional[Any] = None   # the data-parallel wrapper that placed the state

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               ema_decay: Optional[float] = None, ema_batch_stats: bool = False,
               extra: Optional[Any] = None):
        """``ema_batch_stats=True`` also shadows the BatchNorm statistics;
        ``extra`` (e.g. ``models.moco.MocoState``) is saved and restored with the
        state by ``core/checkpoint.py``."""
        device = next(model.parameters()).device
        ema_params = ema_stats = None
        if ema_decay:
            ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
            if ema_batch_stats:     # the running statistics, not the step counters
                ema_stats = {n: b.detach().clone() for n, b in model.named_buffers()
                             if b.is_floating_point()}
        return cls(model, optimizer, 0, torch.zeros((), dtype=torch.float32, device=device),
                   ema_params, ema_stats, extra)


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, momentum=momentum)`` (``eps_in_sqrt=True``,
    ``initial_scale=0``, not centered, no Nesterov): ``ν = decay·ν + (1−decay)·g²``,
    ``u = −lr · g·rsqrt(ν + eps)``, and the trace ``t = u + momentum·t`` is the
    update. foreach ops over each group's parameters."""

    def __init__(self, params, lr: float, decay: float, eps: float, momentum: float):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
                    self.state[p]["trace"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - group["decay"])
            updates = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(updates)
            torch._foreach_mul_(updates, grads)
            torch._foreach_mul_(updates, -group["lr"])
            traces = [self.state[p]["trace"] for p in params]
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, updates)
            torch._foreach_add_(params, traces)


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)``: ``s = s + g²`` from ``s = 0.1``, ``u = −lr ·
    g·rsqrt(s + 1e-7)``. (optax takes a 0 scale where ``s`` is 0, which a start
    of 0.1 never reaches.) foreach ops over each group's parameters."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["sum_of_squares"] = torch.full_like(p, 0.1)
            grads = [p.grad for p in params]
            sums = [self.state[p]["sum_of_squares"] for p in params]
            torch._foreach_addcmul_(sums, grads, grads)
            updates = torch._foreach_add(sums, 1e-7)
            torch._foreach_rsqrt_(updates)
            torch._foreach_mul_(updates, grads)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)


def _split(batch, parts: int):
    """``parts`` micro-batches of a nested dict/tuple batch along axis 0."""
    if isinstance(batch, dict):
        chunks = {k: _split(v, parts) for k, v in batch.items()}
        return [{k: c[i] for k, c in chunks.items()} for i in range(parts)]
    if isinstance(batch, (tuple, list)):
        chunks = [_split(v, parts) for v in batch]
        return [type(batch)(c[i] for c in chunks) for i in range(parts)]
    if batch.shape[0] % parts:
        raise ValueError(f"batch of {batch.shape[0]} does not split into {parts} micro-batches")
    return list(torch.chunk(batch, parts))


def _by_kind(*lists):
    """The aligned ``lists`` split by the kind of the first's tensors, plain or
    FSDP-sharded (``DTensor``): a foreach op takes one kind at a time. One part, the
    lists themselves, where every tensor is plain."""
    kinds = [is_sharded(t) for t in lists[0]]
    return [tuple([t for t, k in zip(lst, kinds) if k == kind] for lst in lists)
            for kind in (False, True) if kind in kinds]


def _global_norm(grads) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm over every gradient, in float32 (over the
    whole of each FSDP-sharded gradient: one all-reduce of the shards' sums)."""
    total = 0.0
    for (part,) in _by_kind(grads):
        squares = sum(torch.sum(g.float() * g.float()) for g in part)
        total = total + whole(squares)
    return torch.sqrt(total)


def forward_module(state: TrainState) -> torch.nn.Module:
    """The module a step runs its loss through: the data-parallel wrapper's where
    the state has one, else the state's module."""
    return state.model if state.parallel is None else state.parallel.forward_module(state)


def _clip_scale(gnorm: torch.Tensor, clip_global_norm: float) -> torch.Tensor:
    """``min(1, clip / (‖g‖ + 1e-12))``, ``optax.clip_by_global_norm``'s factor."""
    return torch.clamp(torch.full_like(gnorm, clip_global_norm) / (gnorm + 1e-12), max=1.0)


def make_train_step(loss_fn: Callable, clip_global_norm: Optional[float] = None,
                    shadow_loss: bool = False, loss_decay: float = 0.9,
                    ema_decay: Optional[float] = None, accum_steps: int = 1,
                    lr_schedule: Optional[Callable] = None):
    """Build ``train_step(state, batch) -> metrics``, which updates ``state``.

    Args:
        loss_fn: ``(model, batch) -> (loss, aux_metrics)``; the step runs the
            model in train mode, so its BatchNorms update their statistics.
        clip_global_norm: optional global-norm gradient clip.
        shadow_loss: the YOLO-family loss-EMA gradient damping.
        ema_decay: optional weight-EMA decay.
        accum_steps: micro-batches per update (the batch's leading dim divides).
        lr_schedule: optional ``step -> lr``, read at ``state.step`` and set into
            every param group before the optimizer steps.

    The metrics are device tensors (``loss``, ``raw_loss``, ``gnorm`` with a
    clip, and ``loss_fn``'s aux); nothing in the step waits for the device.
    """

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model, optimizer, par = state.model, state.optimizer, state.parallel
        model.train()
        optimizer.zero_grad(set_to_none=True)
        fwd = forward_module(state)
        micro = _split(batch, accum_steps) if accum_steps > 1 else [batch]
        losses, auxs = [], []
        for i, mb in enumerate(micro):
            last = i == len(micro) - 1
            with contextlib.nullcontext() if par is None or last else par.accumulating(state):
                loss, aux = loss_fn(fwd, mb)
                loss.backward()
            losses.append(loss.detach())
            auxs.append(aux)
        if par is not None:
            par.finish_grads(state)
        params = [p for p in model.parameters() if p.grad is not None]
        grads = [p.grad for p in params]
        loss = losses[0] if accum_steps == 1 else torch.stack(losses).mean()
        loss = mean_over_ranks(loss)
        aux = {k: mean_over_ranks(torch.stack([torch.as_tensor(a[k]) for a in auxs]).mean(0))
               for k in auxs[0]}
        if accum_steps > 1:
            for (part,) in _by_kind(grads):
                torch._foreach_div_(part, float(accum_steps))

        if shadow_loss:
            decay = float(shadow_loss_decay(state.step, loss_decay))
            use = 1.0 if state.step > 1 else 0.0
            # rounded to float32, as the JAX step computes it on the device
            scale = float(torch.tensor(use * (1.0 - decay) + (1.0 - use)))
            for (part,) in _by_kind(grads):
                torch._foreach_mul_(part, scale)
            blended = scale * loss + use * decay * state.shadow_loss
            state.shadow_loss = blended
            loss_report = blended
        else:
            loss_report = loss

        metrics = {"loss": loss_report, "raw_loss": loss, **aux}
        if clip_global_norm is not None:
            gnorm = _global_norm(grads)
            for (part,) in _by_kind(grads):
                torch._foreach_mul_(part, _clip_scale(gnorm, clip_global_norm))
            metrics["gnorm"] = gnorm

        if lr_schedule is not None:
            for group in optimizer.param_groups:
                group["lr"] = float(lr_schedule(state.step))
        optimizer.step()
        if state.ema_params is not None:
            live = dict(model.named_parameters())
            names = list(state.ema_params)
            for ema, params_now in _by_kind([state.ema_params[n] for n in names],
                                            [live[n].detach() for n in names]):
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, params_now, alpha=1.0 - ema_decay)
            if state.ema_batch_stats is not None:
                buffers = dict(model.named_buffers())
                names = list(state.ema_batch_stats)
                ema = [state.ema_batch_stats[n] for n in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [buffers[n] for n in names], alpha=1.0 - ema_decay)
        state.step += 1
        return metrics

    return train_step


def make_line_search_train_step(loss_fn: Callable, init_lr: float = 0.05, shrink: float = 0.3,
                                min_lr: float = 1e-6, clip_global_norm: float = 10.0,
                                generator: Optional[torch.Generator] = None):
    """Build the line-search step ``train_step(state, batch) -> metrics``
    (``tmv_tpu/core/train_state.py::make_line_search_train_step``).

    The loss and its gradient are taken once; the gradient is clipped to a
    global norm of ``clip_global_norm``; then the parameters become ``p − lr·g``
    for ``lr = init_lr, init_lr·shrink, …`` (float32, as JAX carries it) until
    the re-evaluated loss is below the first one or ``lr`` reaches ``min_lr``.
    The last candidate is kept; the optimizer and the EMA are not touched.

    Each re-evaluation runs in train mode on the same batch, as the JAX step
    applies the model with the step's old statistics: the BatchNorm buffers are
    put back to what the first forward left after every try (torch's train mode
    would update them each time), and ``generator`` (the one ``loss_fn`` feeds
    ``drop_connect``) is rewound, so every try draws the first forward's masks.

    Metrics: ``loss`` (the first), ``new_loss`` (the kept candidate's) and
    ``gnorm``; the loss function's aux.
    """
    shrink32, min32 = np.float32(shrink), np.float32(min_lr)

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        rng_state = generator.get_state() if generator is not None else None
        for p in model.parameters():
            p.grad = None
        loss0, aux = loss_fn(model, batch)
        loss0.backward()
        rng_after = generator.get_state() if generator is not None else None
        params = [p for p in model.parameters() if p.grad is not None]
        grads = [p.grad for p in params]
        gnorm = _global_norm(grads)
        torch._foreach_mul_(grads, _clip_scale(gnorm, clip_global_norm))
        base = [p.detach().clone() for p in params]
        stats = {n: b.detach().clone() for n, b in model.named_buffers()}
        buffers = dict(model.named_buffers())

        @torch.no_grad()
        def try_lr(lr: np.float32) -> torch.Tensor:
            for p, b, g in zip(params, base, grads):
                p.copy_(b - float(lr) * g)
            if generator is not None:
                generator.set_state(rng_state)
            loss, _ = loss_fn(model, batch)
            for n, b in stats.items():
                buffers[n].copy_(b)
            return loss.detach()

        lr = np.float32(init_lr)
        new_loss = try_lr(lr)
        loss0 = loss0.detach()
        while bool(loss0 <= new_loss) and lr > min32:
            lr = np.float32(lr * shrink32)
            new_loss = try_lr(lr)
        if generator is not None:
            generator.set_state(rng_after)
        for p in params:
            p.grad = None
        state.step += 1
        return {"loss": loss0, "new_loss": new_loss, "gnorm": gnorm, **aux}

    return train_step
