"""Spatial partitioning: the image height sharded over ranks, with hand-written halos.

Port of ``tmv_tpu/parallel/spatial.py``. The JAX package builds a ``(data, space)``
mesh, shards every rank ≥ 4 batch leaf whose height the space axis divides as
``P('data', 'space')`` and lets GSPMD insert the gradient all-reduces and the conv halo
exchanges. Here R = D x S ranks are processes (torchrun's, or ``mesh.spawn``'s), laid
out as ``mesh.spatial_mesh`` says, and the exchanges are ``parallel/halo.py``'s:

- ``put_state`` broadcasts rank 0's state to every rank and wraps the module in
  DDP whose gradient hook sums over all R ranks and divides by D: the parameters'
  gradients are partial sums over the space ranks (each back-propagates its own rows)
  and means over the data ranks. DDP's default mean over R would scale them by 1/S.
- ``wrap_step`` runs the step with this rank's shard active process-wide
  (``halo.activated``, ``GroupTransport`` over the space subgroup) and the data group
  active (``collectives.activated``): the losses' normalisers and the metrics reduce
  over the data axis, a split level's BatchNorm over data x space. The module's
  outputs are gathered along H (``halo.gather_heads``), so every space rank computes
  the same loss on the whole heads; the gather's backward keeps this rank's rows,
  which sum over the space ranks to the gradient of one loss.
- ``put_batch`` takes this rank's share of a global batch (``mesh.spatial_share``):
  its data rows of every leaf and its rows of the model input's height; the targets
  stay whole along H, as the loss reads them. ``put_rows`` takes the input's rows of a
  batch that holds this rank's data rows already (a trainer's pipeline decodes only
  those).
- ``wrap_forward`` runs a forward the same way and returns the whole outputs.

The step equals one device's step on the whole batch up to the order of sums (a
shard's convs run at other shapes, cuDNN may pick other algorithms): the JAX
docstring's "bit-identical" holds here within a tolerance per dtype.
"""

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from tmv_tpu_torch.parallel import halo
from tmv_tpu_torch.parallel.collectives import DataGroup, activated
from tmv_tpu_torch.parallel.mesh import init_process_group, spatial_mesh, spatial_share
from tmv_tpu_torch.parallel.train import _Placement, _Replica, replicate_state


def spatial_spec(ndim: int, data_axis: str = "data", space_axis: str = "space") -> tuple:
    """JAX's PartitionSpec of a batch leaf as a tuple of axis names per dim: NHWC
    leaves shard (batch, H)."""
    if ndim >= 4:
        return (data_axis, space_axis)
    if ndim >= 1:
        return (data_axis,)
    return ()


class _SpatialReplica(_Replica):
    """DDP whose outputs are made whole along H on every space rank."""

    def forward(self, *args, **kwargs):
        return halo.gather_heads(super().forward(*args, **kwargs))


def _sum_then_divide(divisor: int):
    """A DDP comm hook: the bucket all-reduced (summed) over every rank, then divided by
    ``divisor``."""

    def hook(group, bucket):
        work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
        return work.get_future().then(lambda fut: fut.value()[0].div_(divisor))

    return hook


class SpatialDataParallel:
    """The ``(data, space)`` mesh and the DDP placement of a
    ``core.train_state.TrainState`` with the image height sharded over ``space``."""

    def __init__(self, data: Optional[int] = None, space: int = 2,
                 devices: Optional[Sequence] = None, device: str = "cuda",
                 input_key: str = "image"):
        self.rank, self.world, self.device = init_process_group(devices, device=device)
        self.mesh = spatial_mesh(space, data)
        self.input_key = input_key
        m = self.mesh
        # the data axis's group; its host group is every rank's, so that a preemption
        # flag stops every rank of the mesh at one step
        self.data_group = DataGroup(m.data_group, m.data_rank, m.data, m.host_group)
        self.stats_group = DataGroup(m.world_group, m.rank, self.world, m.host_group)
        self.grad_divisor = m.data

    @property
    def num_devices(self) -> int:
        return self.world

    @property
    def data_rank(self) -> int:
        return self.mesh.data_rank

    @property
    def data_world(self) -> int:
        return self.mesh.data

    def shard(self, height: int, width: int) -> halo.SpaceShard:
        """This rank's shard of a ``height`` x ``width`` image."""
        m = self.mesh
        return halo.SpaceShard(m.space_rank, m.space, halo.GroupTransport(
            m.space_group, m.space_rank, m.space), height, width, stats=self.stats_group)

    def put_state(self, state):
        """Replicate ``state`` from rank 0 and wrap its module in DDP with the
        sum-over-space, mean-over-data gradient hook (in place)."""
        replicate_state(state)
        ids = [self.device] if self.device.type == "cuda" else None
        replica = _SpatialReplica(state.model, device_ids=ids, broadcast_buffers=False)
        replica.register_comm_hook(None, _sum_then_divide(self.grad_divisor))
        state.parallel = _Placement(replica)
        return state

    def put_batch(self, batch, accum_steps: int = 1):
        """This rank's share of a global batch: its data rows, and its rows of the
        input's height."""
        return spatial_share(batch, self.mesh, (self.input_key,), accum_steps)

    def put_rows(self, batch):
        """This rank's rows of the input's height of a batch that holds its data rows."""
        return spatial_share(batch, self.mesh, (self.input_key,), data_rows=False)

    def put_rng(self, generator: torch.Generator) -> torch.Generator:
        return generator

    def wrap_step(self, train_step: Callable) -> Callable:
        """``train_step(state, batch)`` on this rank's share of the batch (``put_batch``
        or ``put_rows``), inside its shard and the data group."""

        def step(state, batch):
            x = batch[self.input_key]
            shard = self.shard(x.shape[1] * self.mesh.space, x.shape[2])
            with activated(self.data_group), halo.activated(shard, process=True):
                return train_step(state, batch)

        return step

    def wrap_forward(self, apply_fn: Callable) -> Callable:
        """``apply_fn(images, ...)`` on this rank's rows of ``(B, H/S, W, C)`` images →
        its outputs whole along H on every rank."""

        def forward(images, *args, **kwargs):
            shard = self.shard(images.shape[1] * self.mesh.space, images.shape[2])
            with activated(self.data_group), halo.activated(shard, process=True):
                return halo.gather_heads(apply_fn(images, *args, **kwargs), shard)

        return forward
