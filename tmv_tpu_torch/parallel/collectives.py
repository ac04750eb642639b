"""The data group, and the collectives that give a sharded step global-batch semantics.

The JAX package shards a step's batch over the ``data`` axis and GSPMD turns every
reduction over the batch into a ``psum``: the sharded step computes what one device
computes on the whole batch. Here each such reduction is written once, against the
group of the active ``DataParallel``/``FullyShardedDataParallel`` step
(``activated``), and is the identity without one:

- ``global_batch_norm``: the train-mode BatchNorm statistics over every rank's rows
  (``models/layers/common.py::BatchNorm``), its backward all-reducing ``Σ dy`` and
  ``Σ dy·(x − μ)``. On the CPU sum and sum of squares are all-reduced in float32
  (float64 for a float64 input) with the count, flax's ``mean(x²) − mean(x)²``
  variance; on the card each rank's Welford statistics are gathered and merged by
  the fused kernels of ``nn.SyncBatchNorm`` (whose running update, with the unbiased
  variance, is not used);
- ``global_sum``: a detached all-reduced sum, the normaliser of a loss that divides by
  a count over the batch (D0's positives, the focal loss's, the valid triplets);
- ``world``: R, the factor by which a rank's share of a summed loss term is scaled so
  that the mean of the ranks' losses, which DDP's gradient mean differentiates, is the
  global loss;
- ``mean_over_ranks``: the reported metrics, the same on every rank;
- ``all_gather_rows``: the rows of every rank in rank order (MoCo's enqueued keys);
- ``draw_rows``: a random draw of the global batch's shape from a generator every rank
  holds in the same state, sliced to this rank's rows (``drop_connect``).

The rank's rows of a global batch are ``[r·B/R, (r+1)·B/R)`` (``parallel.mesh.
shard_batch``). The group is a process group of its own beside DDP's and FSDP's, so the
order of these collectives never interleaves with theirs.
"""

import contextlib
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataGroup:
    """The process group of the batch axis, this process's rank in it and its size;
    ``host`` is a gloo group for flags agreed on the host (``agree_any``)."""

    group: object
    rank: int
    world: int
    host: object


_ACTIVE: Optional[DataGroup] = None


def active() -> Optional[DataGroup]:
    """The data group of the step that is running, None outside one."""
    return _ACTIVE


@contextlib.contextmanager
def activated(data_group: Optional[DataGroup]):
    """Run the block with ``data_group`` active (the wrapped train step)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, data_group
    try:
        yield
    finally:
        _ACTIVE = previous


def world() -> int:
    """The number of ranks the batch is sharded over (1 without a data group)."""
    return 1 if _ACTIVE is None else _ACTIVE.world


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, detached (``t`` itself without a data group)."""
    t = t.detach()
    if _ACTIVE is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=_ACTIVE.group)
    return t


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks, detached: a loss that is each rank's share of
    the global mean becomes the global mean on every rank."""
    return t.detach() if _ACTIVE is None else global_sum(t) / _ACTIVE.world


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order, detached."""
    t = t.detach()
    if _ACTIVE is None:
        return t
    parts = [torch.empty_like(t) for _ in range(_ACTIVE.world)]
    dist.all_gather(parts, t.contiguous(), group=_ACTIVE.group)
    return torch.cat(parts, 0)


def draw_rows(draw: Callable[[int], torch.Tensor], rows: int) -> torch.Tensor:
    """``draw(n)`` for this rank's ``rows`` of the global batch: the draw of the whole
    global batch (``rows · R``, from a generator in the same state on every rank),
    sliced to rows ``[r·rows, (r+1)·rows)``; ``draw(rows)`` without a data group."""
    if _ACTIVE is None:
        return draw(rows)
    return draw(rows * _ACTIVE.world)[_ACTIVE.rank * rows:(_ACTIVE.rank + 1) * rows]


def agree_any(flag: bool, data_group: Optional[DataGroup]) -> bool:
    """True where ``flag`` is true on any rank of ``data_group`` (a preemption signal
    that reached one rank stops all of them at the same step); ``flag`` without a
    group. A gloo all-reduce of one integer on the host: no device synchronisation."""
    if data_group is None:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=data_group.host)
    return bool(t.item())


def is_sharded(t) -> bool:
    """True for an FSDP-sharded ``DTensor`` (none exists before
    ``torch.distributed.tensor`` is imported, which this module does not do)."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(t, dtensor.DTensor)


def whole(t):
    """A ``DTensor`` made whole on every rank (``full_tensor``, a collective that
    autograd follows); any other value as it is."""
    return t.full_tensor() if is_sharded(t) else t


def _channel_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.dim() - 2))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation by the statistics of the global batch."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        acc = torch.promote_types(x.dtype, torch.float32)   # float32, or float64's own
        xf = x.to(acc)
        local = torch.cat([xf.sum(dims), torch.square(xf).sum(dims),
                           xf.new_full((1,), float(x.numel() // c))])
        dist.all_reduce(local, group=group)
        count = local[2 * c]
        mean = local[:c] / count
        var = torch.clamp(local[c:2 * c] / count - torch.square(mean), min=0.0)
        invstd = torch.rsqrt(var + eps)
        scale = invstd * weight.to(acc)
        y = ((xf - _channel_view(mean, x)) * _channel_view(scale, x)
             + _channel_view(bias.to(acc), x))
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        dyf = dy.to(mean.dtype)
        xmu = x.to(mean.dtype) - _channel_view(mean, x)
        sums = torch.cat([dyf.sum(dims), (dyf * xmu).sum(dims)])
        grad_weight = sums[c:] * invstd
        grad_bias = sums[:c].clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xmu = sums[:c] / count, sums[c:] / count
        dx = (dyf - _channel_view(mean_dy, x)
              - xmu * _channel_view(torch.square(invstd) * mean_dy_xmu, x))
        dx = dx * _channel_view(invstd * weight.to(mean.dtype), x)
        return dx.to(x.dtype), grad_weight.to(weight.dtype), grad_bias.to(weight.dtype), None, None


class _GlobalBatchNormCuda(torch.autograd.Function):
    """``_GlobalBatchNorm`` on the card through the fused kernels ``nn.SyncBatchNorm``
    uses (CUDA only): each rank's Welford mean and inverse std, gathered with the
    counts and merged (``batch_norm_gather_stats_with_counts``; no running update
    there), one normalising kernel; the backward's two local sums all-reduced between
    its two kernels. Four kernels and a gather forward, two kernels and an all-reduce
    backward, where the elementwise form launches ~35 per layer."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, world, running_mean, running_var):
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        local = torch.cat([mean, invstd, mean.new_full((1,), float(x.numel() // c))])
        gathered = local.new_empty((world, local.numel()))
        if dist.get_backend(group) == "gloo":   # gloo has no gather into one tensor
            dist.all_gather(list(gathered.unbind(0)), local, group=group)
        else:
            dist.all_gather_into_tensor(gathered, local, group=group)
        counts = gathered[:, 2 * c]
        # the running statistics (float32, so the merge takes float32 counts) pass
        # through unchanged at momentum 0; the caller updates them by flax's rule
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, gathered[:, :c], gathered[:, c:2 * c], running_mean, running_var, 0.0, eps,
            counts)
        y = torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        ctx.group = group
        var = torch.reciprocal(torch.square(invstd)) - eps   # the biased variance
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last
                           if x.is_contiguous(memory_format=torch.channels_last)
                           else torch.contiguous_format)
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, True, True)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xmu = sums.chunk(2)
        dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                                             counts)
        return dx, grad_weight, grad_bias, None, None, None, None, None


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      group: Optional[DataGroup] = None):
    """``(y, mean, var)``: ``x`` normalised by the mean and biased variance of the
    global batch (float32, whatever ``x``'s type), scaled and shifted, in ``x``'s type;
    the statistics for the running update, which is the caller's (the running
    statistics are read, not changed). Reduces over ``group`` (default: the active
    data group; a height-sharded step passes data x space for a split level). On the
    card the fused kernels (``_GlobalBatchNormCuda``), elsewhere the elementwise form."""
    group = group or _ACTIVE
    if x.is_cuda:
        return _GlobalBatchNormCuda.apply(x, weight, bias, eps, group.group, group.world,
                                          running_mean, running_var)
    return _GlobalBatchNorm.apply(x, weight, bias, eps, group.group)
