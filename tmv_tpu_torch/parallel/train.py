"""Data-parallel training: one call turns a train step into a step over R ranks.

Port of ``tmv_tpu/parallel/train.py::DataParallel``, which jits the step with
replicated state and a data-sharded batch so that XLA inserts the gradient
all-reduce. Here each rank is a process holding the whole state and its rows of
the global batch:

- ``put_state`` broadcasts rank 0's module, EMA, shadow loss and ``extra`` (MoCo's key
  tower and queue) to every rank and wraps the module in
  ``DistributedDataParallel(broadcast_buffers=False)``, whose bucketed gradient
  all-reduce overlaps the backward and averages the ranks' gradients; the state's
  ``parallel`` holds that DDP module, so ``core.train_state.make_train_step`` runs
  the loss through it (``forward_module``: the module's attributes stay reachable
  for the ``loss_fn(model, batch)`` closures) and reduces only the last micro-batch;
- ``wrap_step`` runs the step with the data group active
  (``parallel.collectives``), so every reduction over the batch below it (the
  BatchNorm statistics, the losses' normalisers, the metrics, MoCo's enqueue) is
  the global batch's;
- ``put_batch`` takes this rank's rows of a global batch (``mesh.shard_batch``);
- ``put_rng`` returns the generator: every rank holds it in the same state, and a
  draw inside the step takes the global batch's shape and this rank's slice of it
  (``collectives.draw_rows``).

Ranks are processes: ``n_devices`` is the group's size (torchrun's, or
``mesh.spawn``'s), not a device count to split one process over.
"""

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tmv_tpu_torch.parallel.collectives import DataGroup, activated
from tmv_tpu_torch.parallel.mesh import create_mesh, replicate, shard_batch


class _Replica(DistributedDataParallel):
    """DDP whose module's attributes (``config``, …) are read through it."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.module, name)


def data_group(world: int, rank: int) -> DataGroup:
    """A new group over every rank for the global-batch collectives, with a gloo
    group beside it for host flags. Every rank calls it, in the same order."""
    ranks = list(range(world))
    return DataGroup(dist.new_group(ranks), rank, world, dist.new_group(ranks, backend="gloo"))


def replicate_state(state):
    """Broadcast rank 0's module, EMA, shadow loss and ``extra`` to every rank."""
    replicate(state.model)
    replicate([state.shadow_loss, state.ema_params, state.ema_batch_stats])
    if state.extra is not None:
        replicate([v for v in state.extra.state_dict().values() if not isinstance(v, int)])
        ptr = getattr(state.extra, "queue_ptr", None)
        if ptr is not None:
            t = torch.tensor([ptr], device=state.shadow_loss.device)
            dist.broadcast(t, 0)
            state.extra.queue_ptr = int(t.item())


class _Placement:
    """A state's DDP wrapper, as ``core.train_state.make_train_step`` asks for it."""

    def __init__(self, replica: _Replica):
        self.replica = replica

    def forward_module(self, state) -> torch.nn.Module:
        return self.replica

    def accumulating(self, state):
        """The context of a micro-batch whose gradients stay local (DDP ``no_sync``)."""
        return self.replica.no_sync()

    def finish_grads(self, state):
        """Nothing: DDP's hooks averaged the gradients in the backward."""


class DataParallel:
    """The data mesh and the DDP placement of a ``core.train_state.TrainState``."""

    def __init__(self, n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
                 device: str = "cuda"):
        self.mesh, self.device = create_mesh(n_devices, ("data",), devices=devices,
                                             device=device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.data_group = data_group(self.world, self.rank)

    @property
    def num_devices(self) -> int:
        return self.world

    def put_state(self, state):
        """Replicate ``state`` from rank 0 and wrap its module in DDP (in place); the
        state's ``parallel`` is the placement the train step asks."""
        replicate_state(state)
        ids = [self.device] if self.device.type == "cuda" else None
        state.parallel = _Placement(_Replica(state.model, device_ids=ids,
                                             broadcast_buffers=False))
        return state

    def wrap_step(self, train_step: Callable) -> Callable:
        def step(state, batch):
            with activated(self.data_group):
                return train_step(state, batch)

        return step

    def put_batch(self, batch, accum_steps: int = 1):
        return shard_batch(batch, self.mesh, accum_steps=accum_steps)

    def put_rng(self, generator: torch.Generator) -> torch.Generator:
        return generator
