"""Data-parallel and spatial training and sharded inference over several GPUs.

The data and space axes of ``tmv_tpu/parallel/``: the mesh, the ``(data, space)``
layout and a rank's share of a batch (``mesh``), ``DataParallel`` (``train``, DDP),
``FullyShardedDataParallel`` (``fsdp``, FSDP2), ``SpatialDataParallel`` (``spatial``:
the image height split over ranks, with the hand-written halo exchanges of ``halo``),
the global-batch collectives below a sharded step (``collectives``), and the sharded
batched and height-sharded predictors (``inference``). The tensor and pipeline axes
are not ported yet (ROADMAP.md queue 6).

The names below are imported on first use, so that the modules every train step
imports (``collectives``) do not pull in ``torch.distributed.tensor`` and FSDP.
"""

import importlib

_EXPORTS = {
    "create_mesh": "mesh", "replicate": "mesh", "shard_batch": "mesh",
    "DataParallel": "train",
    "FullyShardedDataParallel": "fsdp", "fsdp_spec": "fsdp",
    "make_sharded_batched_predictor": "inference", "shard_predict": "inference",
    "make_spatial_predictor": "inference", "shard_predict_spatial": "inference",
    "SpatialDataParallel": "spatial", "spatial_spec": "spatial",
    "spatial_mesh": "mesh", "spatial_share": "mesh",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
