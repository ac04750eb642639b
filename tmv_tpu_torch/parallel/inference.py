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

The latency direction, ``shard_predict_spatial`` and ``make_spatial_predictor``
(``serve --spatial``): the image's height split over the device list, a replica of the
module on each entry running its rows in a host thread of its own (entry 0 in the
caller's), with the halo exchanges of ``parallel/halo.py`` between them
(``ThreadTransport``). The heads are gathered in row order on the first device, and
the decode, top-k and NMS run there once, in the family's predict core, as JAX's
``out_shardings`` replicated returns them for the host.
"""

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tmv_tpu_torch.parallel import halo
from tmv_tpu_torch.quant.dynamic import quant_mode, quantized


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


class SpatialForward(torch.nn.Module):
    """A module's forward with the image's height split over ``devices``: shard i runs
    ``replicas[i]`` on rows ``[i·H/S, (i+1)·H/S)`` of the ``(B, H, W, 3)`` images, on
    its own stream and host thread (shard 0 on the caller's), in the caller's
    quantization and grad modes; the NHWC outputs (any nesting of tuples) come back
    whole on ``devices[0]``: a split level's rows concatenated in shard order, a
    gathered level's (every shard computes it alike) shard 0's. Its parameters are
    the replicas' (``next(parameters())`` is on ``devices[0]``). ``close()`` stops the
    threads."""

    def __init__(self, replicas: Sequence[torch.nn.Module], devices: Sequence):
        super().__init__()
        self.replicas = torch.nn.ModuleList(replicas)
        self.devices = [torch.device(d) for d in devices]
        self.streams = [None] + [torch.cuda.Stream(d) if d.type == "cuda" else None
                                 for d in self.devices[1:]]
        self.pool = ThreadPoolExecutor(max(1, len(replicas) - 1))

    def close(self):
        self.pool.shutdown(wait=True)

    def forward(self, images: torch.Tensor, *args, **kwargs):
        size = len(self.replicas)
        height, width = images.shape[1], images.shape[2]
        if height % size:
            raise ValueError(f"an image {height} rows high does not split over {size} shards")
        rows = height // size
        board = halo.ThreadBoard(size)
        mode, grad = quant_mode(), torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        ready = None
        if images.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(images.device))

        def run(i):
            shard = halo.SpaceShard(i, size, halo.ThreadTransport(board, i), height, width)
            try:
                with contextlib.ExitStack() as stack:
                    stream = self.streams[i]
                    if stream is not None:
                        stack.enter_context(torch.cuda.device(self.devices[i]))
                        stack.enter_context(torch.cuda.stream(stream))
                        stream.wait_event(ready)
                    stack.enter_context(torch.inference_mode(inference))
                    stack.enter_context(torch.set_grad_enabled(grad))
                    stack.enter_context(quantized(mode))
                    stack.enter_context(halo.activated(shard))
                    x = images[:, i * rows:(i + 1) * rows].to(self.devices[i])
                    out = self.replicas[i](x, *args, **kwargs)
                    done = None
                    if stream is not None:
                        done = torch.cuda.Event()
                        done.record(stream)
                    return out, done, shard
            except BaseException:
                board.abort()
                raise

        futures = [self.pool.submit(run, i) for i in range(1, size)]
        results = [run(0)] + [f.result() for f in futures]
        here = torch.cuda.current_stream(self.devices[0]) if images.is_cuda else None
        for _, done, _ in results:
            if done is not None:
                here.wait_event(done)
        return self._gather([out for out, _, _ in results], results[0][2], here)

    def _gather(self, outs, shard, stream):
        first = outs[0]
        if isinstance(first, (tuple, list)):
            return type(first)(self._gather([o[k] for o in outs], shard, stream)
                               for k in range(len(first)))
        if not torch.is_tensor(first) or first.dim() < 4 \
                or first.shape[1] == shard.height_of(first.shape[2]):
            return first
        parts = []
        for t in outs:
            if stream is not None and t.device == self.devices[0]:
                t.record_stream(stream)
            parts.append(t.to(self.devices[0]))
        return torch.cat(parts, 1)


def shard_predict_spatial(replicas: Sequence[torch.nn.Module], devices: Sequence) -> SpatialForward:
    """The height-sharded forward of ``replicas`` (one per entry of ``devices``, each on
    its device) as one module (``SpatialForward``), for a family's predict core."""
    if len(replicas) != len(devices) or len(replicas) < 1:
        raise ValueError(f"{len(replicas)} replicas for {len(devices)} devices")
    return SpatialForward(replicas, devices)


def make_spatial_predictor(model: torch.nn.Module, make_batched: Callable, n_devices: int = 0,
                           devices: Optional[Sequence] = None, device: str = "cuda"):
    """For the serve CLI: ``model`` on ``replica_devices(...)`` (entry 0 ``model``
    itself where it lies there, a deep copy elsewhere) behind ``shard_predict_spatial``,
    and the family's batched predictor on it (``make_batched(spatial_forward)``);
    returns ``(predict, None, devices)`` as ``make_sharded_batched_predictor``.
    ``predict.close()`` stops the threads."""
    devices = replica_devices(n_devices, devices, device)
    replicas = [model if i == 0 and next(model.parameters()).device == d
                else copy.deepcopy(model).to(d) for i, d in enumerate(devices)]
    forward = shard_predict_spatial(replicas, devices)
    predict = make_batched(forward)
    predict.close = forward.close
    return predict, None, devices
