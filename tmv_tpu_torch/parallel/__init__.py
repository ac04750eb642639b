"""Data-parallel training and sharded inference over several GPUs.

The data half of ``tmv_tpu/parallel/``: the mesh and a rank's share of a batch
(``mesh``), ``DataParallel`` (``train``, DDP), ``FullyShardedDataParallel``
(``fsdp``, FSDP2), the global-batch collectives below a sharded step
(``collectives``) and the sharded batched predictor (``inference``). The spatial,
tensor and pipeline axes are not ported yet (ROADMAP.md queue 6).

The names below are imported on first use, so that the modules every train step
imports (``collectives``) do not pull in ``torch.distributed.tensor`` and FSDP.
"""

import importlib

_EXPORTS = {
    "create_mesh": "mesh", "replicate": "mesh", "shard_batch": "mesh",
    "DataParallel": "train",
    "FullyShardedDataParallel": "fsdp", "fsdp_spec": "fsdp",
    "make_sharded_batched_predictor": "inference", "shard_predict": "inference",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
