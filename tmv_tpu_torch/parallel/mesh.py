"""The data mesh: the process group, its ``DeviceMesh``, and a rank's share of a batch.

Port of ``tmv_tpu/parallel/mesh.py``. JAX drives every device from one process and
places a batch on a ``Mesh`` by its sharding; PyTorch runs one process per device,
so here a mesh is a ``torch.distributed`` process group of R ranks and the
``DeviceMesh`` over it (``init_device_mesh``), and placing a batch means taking this
rank's rows of the global batch:

- ``init_process_group``: started once per process. NCCL where the ranks hold
  distinct cards, gloo on the CPU and where ranks share a card (NCCL refuses two
  ranks on one device); from torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``), from the caller's rank, world and address, or a
  one-rank group on a private store;
- ``create_mesh``: the ``DeviceMesh`` of the group, this rank's device with it;
- ``shard_rows``/``shard_batch``: rank r holds rows ``[r·B/R, (r+1)·B/R)`` of a
  global batch of B rows, or with ``accum_steps`` = a its rows of each of the a global
  micro-batches in turn; an indivisible batch raises JAX's error;
- ``replicate``: a broadcast from rank 0 of a module's parameters and buffers (or of
  tensors), so every rank starts from rank 0's values;
- ``spawn``: one process per rank from a plain ``python -m`` run (start method
  ``spawn``), as the JAX CLIs' ``--dp`` takes every local device.

- ``spatial_mesh``: the 2-D ``(data, space)`` layout of the group (rank r is data row
  ``r // S`` and space column ``r % S``, the JAX mesh's row-major order), with each
  rank's data and space subgroups; ``spatial_share``: a rank's share of a global batch,
  its data rows and, for the model input where it is of rank ≥ 4 and S divides its
  height (dim 1), its rows of that height
  (``tmv_tpu/parallel/spatial.py::SpatialDataParallel.leaf_sharding``'s rule, which
  lays out the other leaves along H too; their values stay whole here, as there).

``batch_sharding`` and ``replicated_sharding`` have no counterpart: a PyTorch rank
holds plain tensors, its rows of the batch and a whole copy of the state, so there is
no sharding object to hand to a compiler.
"""

import os
import socket
from dataclasses import dataclass
from typing import Callable, Collection, List, Optional, Sequence

import torch
import torch.distributed as dist


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_devices(world: int, device: str = "cuda") -> List[torch.device]:
    """The default device of each of ``world`` ranks: ``cuda:0 … cuda:R−1`` (an error
    where the host has fewer cards), or the CPU for every rank."""
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * world
    have = torch.cuda.device_count()
    if world > have:
        raise ValueError(f"{world} ranks need {world} GPUs; this host has {have}")
    return [torch.device("cuda", i) for i in range(world)]


def init_process_group(devices: Optional[Sequence] = None, rank: Optional[int] = None,
                       world: Optional[int] = None, init_method: Optional[str] = None,
                       device: str = "cuda"):
    """Start this process's default group once; returns ``(rank, world, device)``.

    ``devices`` lists every rank's device (default ``rank_devices(world, device)``); ranks on
    distinct cards join by NCCL, ranks on the CPU or sharing a card by gloo. The rank
    and world come from the arguments, else torchrun's environment, else a group of
    one on a private store."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif rank is None and launched_by_torchrun():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    elif rank is None:
        rank, world = 0, 1
    devices = [torch.device(d) for d in (devices or rank_devices(world, device))]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    device = devices[rank]
    if not dist.is_initialized():
        shared = len(set(devices)) < len(devices)
        backend = "nccl" if device.type == "cuda" and not shared else "gloo"
        kw = dict(backend=backend, rank=rank, world_size=world)
        if backend == "nccl":
            kw["device_id"] = device
        if init_method is None and world == 1:
            dist.init_process_group(store=dist.HashStore(), **kw)
        else:
            dist.init_process_group(init_method=init_method, **kw)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return rank, world, device


def create_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None,
                device: str = "cuda"):
    """``(mesh, device)``: the ``DeviceMesh`` over the process group (started here
    where it is not yet: torchrun's, or a group of one) and this rank's device.
    ``n_devices``, where given, must be the group's size: one process drives one
    device. ``devices`` pins each rank's device (``devices[r]`` for rank r; default
    ``rank_devices(world, device)``)."""
    from torch.distributed.device_mesh import init_device_mesh

    rank, world, device = init_process_group(devices, device=device)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks "
                         "(one process per device: launch that many ranks)")
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axis_names) - 1)
    mesh = init_device_mesh(device.type, shape, mesh_dim_names=tuple(axis_names))
    return mesh, device


def shard_rows(batch_size: int, rank: int, world: int, accum_steps: int = 1) -> List[int]:
    """Rank ``rank``'s rows of a global batch of ``batch_size``: with ``accum_steps``
    = a, its ``B/(a·R)`` rows of each global micro-batch ``[i·B/a, (i+1)·B/a)`` in
    turn (a = 1: ``[r·B/R, (r+1)·B/R)``). Raises where ``a·R`` does not divide B."""
    parts = accum_steps * world
    if batch_size % parts:
        raise ValueError(
            f"a batch sharded over {world} ranks ({accum_steps} micro-batches each) implies "
            f"that the global size of its dimension 0 should be divisible by {parts}, but "
            f"it is equal to {batch_size}")
    per = batch_size // parts
    micro = batch_size // accum_steps
    return [i * micro + rank * per + k for i in range(accum_steps) for k in range(per)]


def _mesh_rank(mesh, axis: str):
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def shard_batch(batch, mesh, axis: str = "data", accum_steps: int = 1):
    """This rank's rows (``shard_rows``) of every tensor or array of a nested
    dict/tuple/list batch whose leading dimension is the global batch."""
    rank, world = _mesh_rank(mesh, axis)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        rows = shard_rows(x.shape[0], rank, world, accum_steps)
        if torch.is_tensor(x):
            return x[torch.as_tensor(rows, device=x.device)]
        return x[rows]

    return take(batch)


@dataclass(frozen=True)
class SpatialMesh:
    """This rank's place on the ``(data, space)`` layout of the process group and the
    groups it reduces over: ``data_group`` (the ranks of its space column),
    ``space_group`` (of its data row), ``world_group`` (every rank) and ``host_group``
    (every rank, gloo: flags agreed on the host)."""

    data: int
    space: int
    rank: int
    data_rank: int
    space_rank: int
    data_group: object
    space_group: object
    world_group: object
    host_group: object


def spatial_mesh(space: int, data: Optional[int] = None) -> SpatialMesh:
    """The ``(data, space)`` layout of the started group: ``data`` (default R / S)
    times ``space`` must be its size R. Every rank creates every subgroup, in the same
    order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    data = data or world // space
    if data * space != world or space < 1:
        raise ValueError(f"mesh {data}x{space} needs {data * space} ranks, have {world}")
    data_rank, space_rank = divmod(rank, space)
    rows = [dist.new_group([d * space + s for s in range(space)]) for d in range(data)]
    columns = [dist.new_group([d * space + s for d in range(data)]) for s in range(space)]
    everyone = list(range(world))
    return SpatialMesh(data, space, rank, data_rank, space_rank, columns[space_rank],
                       rows[data_rank], dist.new_group(everyone),
                       dist.new_group(everyone, backend="gloo"))


def space_splits(shape: Sequence[int], space: int) -> bool:
    """JAX's leaf rule: a leaf of rank ≥ 4 whose dim 1 (H of NHWC) ``space`` divides
    is split along it; others are split over data only."""
    return len(shape) >= 4 and shape[1] % space == 0


def spatial_share(batch, mesh: SpatialMesh, space_keys: Collection[str], accum_steps: int = 1,
                  data_rows: bool = True):
    """This rank's share of a dict batch: its data rows of every leaf (``shard_rows`` over
    the data axis; ``data_rows=False`` for a batch that holds them already) and, of the
    leaves under ``space_keys`` that ``space_splits``, its space rows of the height. The
    other leaves stay whole along H, as a loss reads them (JAX's leaf rule lays out every
    such leaf along H, but its values stay whole there too)."""

    def take(x, split):
        if isinstance(x, dict):
            return {k: take(v, split) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(take(v, split) for v in x)
        if data_rows:
            rows = shard_rows(x.shape[0], mesh.data_rank, mesh.data, accum_steps)
            x = x[torch.as_tensor(rows, device=x.device)] if torch.is_tensor(x) else x[rows]
        if split and space_splits(x.shape, mesh.space):
            n = x.shape[1] // mesh.space
            x = x[:, mesh.space_rank * n:(mesh.space_rank + 1) * n]
        return x

    return {k: take(v, k in space_keys) for k, v in batch.items()}


@torch.no_grad()
def replicate(tree, mesh=None, src: int = 0):
    """Broadcast from rank ``src`` into every rank: a module's parameters and buffers,
    or the tensors of a nested dict/list. Returns ``tree`` (updated in place). The
    mesh is the whole process group (``mesh`` is taken for JAX's signature)."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict(keep_vars=True).values())
    else:
        tensors = []

        def walk(x):
            if torch.is_tensor(x):
                tensors.append(x)
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        walk(tree)
    for t in tensors:
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=src)
    return tree


def _spawned(index: int, fn: Callable, world: int, init_method: str, devices, args):
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    init_process_group(devices, index, world, init_method)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, devices: Optional[Sequence] = None,
          device: str = "cuda", join: bool = True):
    """Run ``fn(*args)`` in ``world`` new processes (start method ``spawn``), each in
    the process group as rank 0 … R−1 on ``devices[r]`` (default ``rank_devices``),
    joined on a free localhost port, its CPU threads a share of the host's. A rank
    that fails fails the call. With ``join=False`` returns at once with the
    processes' context (``context.join()`` until it returns True)."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in (devices or rank_devices(world, device))]
    init_method = f"tcp://localhost:{free_port()}"
    return mp.start_processes(_spawned, args=(fn, world, init_method, devices, args),
                              nprocs=world, join=join, start_method="spawn")
