"""Data-parallel sharded inference: one predictor replica per device, one process.

Port of the data half of ``tmv_tpu/parallel/inference.py``. There, the batched
predictor is one jitted program whose batch dimension is sharded over a mesh with
replicated variables; the per-image decode and NMS tail is batch-local, so the
program holds no collective. Here each entry of an explicit device list holds a
replica of the module and its batched predictor; a call splits the batch in order
into equal contiguous chunks, runs each replica on its own ``torch.cuda.Stream``
from its own host thread (the b1-b16 forwards are host-bound, so one thread would
serialise them), and concatenates the outputs in batch order. No collectives, as in
JAX. Two replicas may share a card (``[cuda:0, cuda:0]``): each has its own
weights, stream and thread, and the kernels launch on the calling thread's current
stream, keyed caches by the weights' address (``kernels/int8_conv.py``'s TMA maps).

Use it under the serving micro-batch queue: ``MicroBatcher`` pads every batch to
``max_batch``, so a capacity that the replica count divides keeps every chunk's
shape static.

``shard_predict_spatial`` and ``make_spatial_predictor`` (the image's height split
over devices, with halo exchanges) are not ported yet (ROADMAP.md queue 6).
"""

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def replica_devices(n_devices: int = 0, devices: Optional[Sequence] = None,
                    device: str = "cuda") -> List[torch.device]:
    """The replicas' devices: ``devices`` as given, else ``cuda:0 … cuda:N−1`` (N =
    ``n_devices``, 0 = every card); N above the host's card count is an error. On the
    CPU (``device='cpu'``) ``n_devices`` replicas on the CPU."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * max(1, n_devices)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or have
    if n < 1 or n > have:
        raise ValueError(f"{n} replicas need {n} GPUs; this host has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def shard_predict(predict_fns: Sequence[Callable], devices: Sequence) -> Callable:
    """``predict(variables, images)``: the batch split in order into
    ``len(predict_fns)`` chunks, chunk i through ``predict_fns[i]`` on ``devices[i]``
    on a stream and a host thread of its own, the outputs (tuples of host arrays
    with a leading batch axis) concatenated in batch order. The batch must divide
    evenly. ``predict.close()`` stops the threads."""
    devices = [torch.device(d) for d in devices]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]
    pool = ThreadPoolExecutor(len(predict_fns))

    def run(i, variables, chunk):
        if streams[i] is None:
            return predict_fns[i](variables, chunk)
        with torch.cuda.device(devices[i]), torch.cuda.stream(streams[i]):
            return predict_fns[i](variables, chunk)

    def predict(variables, images):
        n = len(predict_fns)
        if images.shape[0] % n:
            raise ValueError(f"a batch of {images.shape[0]} does not split over {n} replicas")
        size = images.shape[0] // n
        chunks = [images[i * size:(i + 1) * size] for i in range(n)]
        outs = list(pool.map(run, range(n), [variables] * n, chunks))
        return tuple(np.concatenate([np.asarray(o[k]) for o in outs])
                     for k in range(len(outs[0])))

    predict.close = lambda: pool.shutdown(wait=True)
    return predict


def make_sharded_batched_predictor(model: torch.nn.Module, make_batched: Callable,
                                   n_devices: int = 0, devices: Optional[Sequence] = None,
                                   device: str = "cuda"):
    """For the serve CLI: a replica of ``model`` on each of ``replica_devices(...)``
    (a deep copy, so a calibrated int8 module keeps its scales) and its batched
    predictor ``make_batched(replica)``; returns ``(sharded_predict, None, devices)``
    as JAX returns ``(sharded, placed_variables, mesh)`` (the replicas hold their
    weights: the predictor's ``variables`` argument is unused)."""
    devices = replica_devices(n_devices, devices, device)
    fns = []
    for d in devices:
        replica = copy.deepcopy(model).to(d)
        fns.append(make_batched(replica))
    return shard_predict(fns, devices), None, devices
