"""How the trainers' ``--dp`` and ``--fsdp`` start their ranks.

- Under ``torchrun`` (or inside ranks already started), the trainer runs in each
  rank and joins the group from the environment.
- Run plainly, it runs once per visible card: one process per card, started by
  ``mesh.spawn`` (start method ``spawn``), as the JAX CLIs' ``--dp`` takes every local
  device; with one card (or on the CPU) it runs in this process, a group of one.

Rank 0 alone logs, validates and writes; the others return None.
"""

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from tmv_tpu_torch.parallel.mesh import launched_by_torchrun, spawn


def run_ranks(train: Callable, args):
    """``train(args)`` in every rank ``--dp``/``--fsdp`` asks for (once without them);
    returns its result in this process, None where it ran in spawned ranks."""
    if not (args.dp or args.fsdp) or dist.is_initialized() or launched_by_torchrun():
        return train(args)
    cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    if cards <= 1:
        return train(args)
    spawn(train, cards, args, device=args.device)
    return None


@contextlib.contextmanager
def data_parallel(args):
    """The wrapper ``--dp``/``--fsdp`` ask for (None without them) on this rank's
    device; a group started here is torn down after the block."""
    if not (args.dp or args.fsdp):
        yield None
        return
    from tmv_tpu_torch.parallel.fsdp import FullyShardedDataParallel
    from tmv_tpu_torch.parallel.train import DataParallel

    owned = not dist.is_initialized()
    wrapper = (FullyShardedDataParallel if args.fsdp else DataParallel)(device=args.device)
    try:
        yield wrapper
    finally:
        if owned:
            dist.destroy_process_group()
