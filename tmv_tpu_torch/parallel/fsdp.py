"""Fully-sharded data parallelism (ZeRO-3) over the ``data`` axis, by FSDP2.

Port of ``tmv_tpu/parallel/fsdp.py``. The compute is ``DataParallel``'s (each rank
its rows of the global batch, the global-batch collectives of
``parallel.collectives``); the *storage* of every large parameter, of its gradient,
of its optimizer state and of its EMA mirror is split 1/R over the ranks. Where GSPMD
derives the gather/reduce-scatter schedule from sharding annotations, here
``torch.distributed.fsdp.fully_shard`` runs it: it all-gathers a unit's weights
before its forward and backward, frees them after, and reduce-scatters the gradients
(averaged over the ranks) into the shards.

``fsdp_spec`` is the JAX rule unchanged: a leaf of at least ``min_size`` elements
shards along its largest dim that the axis size divides, ties to the last; others
stay replicated. It is evaluated on the leaf's flax shape (conv kernels HWIO, dense
kernels (in, out)), and its choice is mapped to the same logical dim of the torch
tensor (OIHW, (out, in)) that ``shard_placement_fn`` hands FSDP2 (``torch_dim``).

The leaves the rule replicates stay whole: they are FSDP2's ``ignored_params`` (it
also refuses to shard a 0-d parameter, e.g. the BiFPN fusion weights), their
gradients averaged over the ranks by this wrapper after the backward. FSDP2's
sharded parameters are ``DTensor`` s and the replicated ones plain tensors, which
one foreach op cannot take together: the rebuilt optimizer holds the two kinds in
two parameter groups of the same hyperparameters, and the train step runs its
foreach ops on each kind apart (``core.train_state._by_kind``). A checkpoint is
gathered whole (``full_state``) into the single-device format: one parameter group
in module order, so ``serve``, ``eval_map`` and a plain resume read it; a plain
checkpoint resumes under FSDP by ``put_state`` after the restore.

``wrap_forward`` is the sharded-storage forward of the JAX wrapper: the module
placed by ``put_state`` (or a module sharded alone) run on each rank's rows, the
outputs gathered whole in batch order.
"""

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from tmv_tpu_torch.parallel.collectives import activated, all_gather_rows, whole
from tmv_tpu_torch.parallel.mesh import create_mesh, shard_batch
from tmv_tpu_torch.parallel.train import data_group, replicate_state


def fsdp_spec(shape: Sequence[int], axis_size: int, min_size: int = 1024) -> Optional[int]:
    """The dim of ``shape`` (flax layout) that shards over an axis of ``axis_size``,
    or None where the leaf stays replicated: the largest divisible dim, ties to the
    last, for a leaf of at least ``min_size`` elements (JAX's ``fsdp_spec``, which
    returns the ``PartitionSpec`` naming that dim)."""
    if not shape:
        return None
    size = 1
    for d in shape:
        size *= d
    if size < min_size:
        return None
    best = None
    for i, d in enumerate(shape):  # later dims win ties
        if d % axis_size == 0 and (best is None or d >= shape[best]):
            best = i
    return best


# torch dim of each flax dim: a conv kernel HWIO ↔ OIHW, a dense kernel (in, out) ↔ (out, in)
_TORCH_DIM = {4: (2, 3, 1, 0), 2: (1, 0)}


def flax_shape(t: torch.Tensor) -> tuple:
    """The flax layout of a port parameter's shape (conv OIHW → HWIO, dense
    (out, in) → (in, out); other ranks as they are)."""
    s = tuple(t.shape)
    if t.dim() == 4:
        return (s[2], s[3], s[1], s[0])
    if t.dim() == 2:
        return (s[1], s[0])
    return s


def torch_dim(t: torch.Tensor, flax_dim: int) -> int:
    """The dim of the torch tensor ``t`` that is ``flax_dim`` of its flax layout."""
    return _TORCH_DIM[t.dim()][flax_dim] if t.dim() in _TORCH_DIM else flax_dim


def shard_dim(t: torch.Tensor, axis_size: int, min_size: int = 1024) -> Optional[int]:
    """``fsdp_spec`` of ``t``'s flax shape, as a dim of ``t`` (None: replicated)."""
    dim = fsdp_spec(flax_shape(t), axis_size, min_size)
    return None if dim is None else torch_dim(t, dim)


def _as_local_shard(full: torch.Tensor, like: DTensor) -> DTensor:
    """``full`` (every rank holds it whole) as a DTensor of ``like``'s placement:
    each rank keeps its own slice, no communication."""
    return distribute_tensor(full.to(like.device).contiguous(), like.device_mesh,
                             like.placements, src_data_rank=None)


class FullyShardedDataParallel:
    """1-D ``data`` mesh: the batch and the state's storage shard over it.

    ``put_state`` shards a ``core.train_state.TrainState`` in place (the module's
    direct children that hold parameters, then the root, each an FSDP2 unit), rebuilds
    its optimizer over the sharded parameters with the optimizer's state sharded
    alike, and shards the EMA mirrors as their parameters; ``wrap_step`` runs the
    unchanged step with the data group active. ``min_size`` is ``fsdp_spec``'s."""

    def __init__(self, n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
                 min_size: int = 1024, device: str = "cuda"):
        self.mesh, self.device = create_mesh(n_devices, ("data",), devices=devices,
                                             device=device)
        self.min_size = min_size
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.data_group = data_group(self.world, self.rank)

    @property
    def num_devices(self) -> int:
        return self.world

    def shard_module(self, model: torch.nn.Module) -> torch.nn.Module:
        """Shard ``model`` in place by ``fsdp_spec``; returns it. FSDP2 takes contiguous
        parameters only: ``channels_last`` conv weights become contiguous (the convs
        still run on ``channels_last`` activations)."""
        from torch.distributed.fsdp import fully_shard

        with torch.no_grad():
            for p in model.parameters():
                if not p.is_contiguous():
                    p.data = p.data.contiguous()
        dims = {p: shard_dim(p, self.world, self.min_size) for p in model.parameters()}
        ignored = {p for p, d in dims.items() if d is None}
        kw = dict(mesh=self.mesh, ignored_params=ignored,
                  shard_placement_fn=lambda p: Shard(dims[p]))
        for child in model.children():
            if any(p not in ignored for p in child.parameters()):
                fully_shard(child, **kw)
        fully_shard(model, **kw)
        return model

    def put_state(self, state):
        """Replicate ``state`` from rank 0, then shard it (in place)."""
        replicate_state(state)
        old = state.optimizer
        if len(old.param_groups) != 1:
            raise ValueError("FSDP rebuilds a one-group optimizer over the sharded module")
        before = list(state.model.parameters())
        moments = [old.state.get(p, {}) for p in before]
        self.shard_module(state.model)
        params = list(state.model.parameters())
        hyper = {k: v for k, v in old.param_groups[0].items() if k != "params"}
        groups = [{"params": [p for p in params if isinstance(p, DTensor) == kind]}
                  for kind in (True, False)]
        new = type(old)([g for g in groups if g["params"]], **hyper)
        for p, m in zip(params, moments):
            if m:
                new.state[p] = {k: (_as_local_shard(v, p) if isinstance(p, DTensor)
                                    and torch.is_tensor(v) and v.shape == p.shape else v)
                                for k, v in m.items()}
        state.optimizer = new
        if state.ema_params is not None:
            live = dict(state.model.named_parameters())
            state.ema_params = {n: (_as_local_shard(e, live[n]) if isinstance(live[n], DTensor)
                                    else e) for n, e in state.ema_params.items()}
        state.parallel = self
        return state

    def forward_module(self, state) -> torch.nn.Module:
        return state.model

    def accumulating(self, state):
        """Each micro-batch's backward reduce-scatters into the sharded gradients,
        which accumulate there: nothing to hold back."""
        return contextlib.nullcontext()

    def finish_grads(self, state):
        """Average the replicated parameters' gradients over the ranks (FSDP2 does not
        reduce its ``ignored_params``'), in one all-reduce of their concatenation."""
        grads = [p.grad for p in state.model.parameters()
                 if not isinstance(p, DTensor) and p.grad is not None]
        if not grads or self.world == 1:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group.group)
        flat /= self.world
        parts = torch.split(flat, [g.numel() for g in grads])
        torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(parts, grads)])

    def wrap_step(self, train_step: Callable) -> Callable:
        def step(state, batch):
            with activated(self.data_group):
                return train_step(state, batch)

        return step

    def wrap_forward(self, model: torch.nn.Module) -> Callable:
        """``images -> outputs`` of the sharded ``model`` (sharded here unless
        ``put_state`` did it): each rank runs its rows of the global batch, and the
        outputs are gathered whole on every rank in batch order, as JAX returns them
        replicated."""
        if not any(isinstance(p, DTensor) for p in model.parameters()):
            self.shard_module(model)

        def gather(out):
            if isinstance(out, (tuple, list)):
                return type(out)(gather(o) for o in out)
            return all_gather_rows(out)

        def forward(images):
            with activated(self.data_group):
                return gather(model(self.put_batch(images)))

        return forward

    def put_batch(self, batch, accum_steps: int = 1):
        return shard_batch(batch, self.mesh, accum_steps=accum_steps)

    def put_rng(self, generator: torch.Generator) -> torch.Generator:
        return generator

    def full_state(self, state) -> Dict:
        """The state gathered whole, in the single-device format: ``model`` (the
        ``state_dict``), ``optimizer`` (one group, parameters in module order) and
        ``ema_params``. A collective: every rank calls it, in the same order."""
        params = list(state.model.parameters())
        opt = state.optimizer
        group = {k: v for k, v in opt.param_groups[0].items() if k != "params"}
        group["params"] = list(range(len(params)))
        optimizer = {"state": {i: {k: whole(v) for k, v in opt.state[p].items()}
                               for i, p in enumerate(params) if p in opt.state},
                     "param_groups": [group]}
        ema = (None if state.ema_params is None
               else {n: whole(e) for n, e in state.ema_params.items()})
        return {"model": {k: whole(v) for k, v in state.model.state_dict().items()},
                "optimizer": optimizer, "ema_params": ema}
