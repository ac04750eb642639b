"""How the trainers' ``--dp``, ``--fsdp`` and ``--sp`` start their ranks.

- Under ``torchrun`` (or inside ranks already started), the trainer runs in each
  rank and joins the group from the environment.
- Run plainly, it runs once per visible card: one process per card, started by
  ``mesh.spawn`` (start method ``spawn``), as the JAX CLIs' ``--dp`` takes every local
  device; with one card (or on the CPU) it runs in this process, a group of one.
- ``--sp N`` needs a multiple of N ranks: N·⌊cards / N⌋ of them on as many cards, or,
  with fewer than N cards, N ranks sharing them (rank r on card r mod cards; gloo
  where ranks share a card), N ranks on the CPU.

Rank 0 alone logs, validates and writes; the others return None.
"""

import contextlib
import os
from typing import Callable

import torch
import torch.distributed as dist

from tmv_tpu_torch.parallel.mesh import launched_by_torchrun, spawn


def shared_devices(world: int, device: str = "cuda"):
    """Rank r's device for ``world`` ranks on the host's cards: ``cuda:(r mod cards)``
    (or the CPU for every rank)."""
    if torch.device(device).type != "cuda":
        return ["cpu"] * world
    cards = max(1, torch.cuda.device_count())
    return [f"cuda:{r % cards}" for r in range(world)]


def spatial_devices(space: int, device: str = "cuda"):
    """The ranks' devices of ``--sp space`` run plainly (see the module's note)."""
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    return shared_devices(space * max(1, cards // space), device)


def run_ranks(train: Callable, args):
    """``train(args)`` in every rank ``--dp``/``--fsdp``/``--sp`` asks for (once without
    them); returns its result in this process, None where it ran in spawned ranks."""
    sp = getattr(args, "sp", 1) > 1
    if not (args.dp or args.fsdp or sp) or dist.is_initialized() or launched_by_torchrun():
        return train(args)
    if sp:
        devices = spatial_devices(args.sp, args.device)
        spawn(train, len(devices), args, devices=devices)
        return None
    cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    if cards <= 1:
        return train(args)
    spawn(train, cards, args, device=args.device)
    return None


@contextlib.contextmanager
def data_parallel(args):
    """The wrapper ``--dp``/``--fsdp``/``--sp`` ask for (None without them) on this
    rank's device; a group started here is torn down after the block."""
    sp = getattr(args, "sp", 1)
    if not (args.dp or args.fsdp or sp > 1):
        yield None
        return
    from tmv_tpu_torch.parallel.fsdp import FullyShardedDataParallel
    from tmv_tpu_torch.parallel.spatial import SpatialDataParallel
    from tmv_tpu_torch.parallel.train import DataParallel

    owned = not dist.is_initialized()
    if sp > 1:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", sp)))
        wrapper = SpatialDataParallel(space=sp, devices=shared_devices(world, args.device),
                                      device=args.device)
    else:
        wrapper = (FullyShardedDataParallel if args.fsdp else DataParallel)(device=args.device)
    try:
        yield wrapper
    finally:
        if owned:
            dist.destroy_process_group()
