"""The spatial axis below the layers: each level's rows on a shard, and the halo exchange.

The JAX package splits an image's height over a ``space`` mesh axis and lets GSPMD
insert the halo exchanges (``tmv_tpu/parallel/spatial.py``). Here they are written out.
A forward split over S shards runs once per shard (a host thread each, or a process
each), and every layer helper that reads rows of its input beyond its own
(``layers.common``: the TF-SAME and Darknet convs, the pools, the nearest resizes; the
depthwise and int8 kernels' callers) asks this module for the rows its shard's output
rows need. Outside a spatial forward (``active()`` is None) every function here is the
identity.

- **Levels and rows.** A level of global height H is *split* where S divides H: shard
  r holds rows ``[r·H/S, (r+1)·H/S)``. Otherwise it is *gathered*: every shard holds
  all H rows and computes them alike (YOLO's 13-row level at 416 over 2 shards, a
  2-row level over 4). The global height of a local NCHW tensor is read from its
  width, which is never split (``SpaceShard.height_of``).
- **Windows.** ``window_rows(x, k, stride, top, bottom)`` returns the input rows of the
  shard's output rows of a k-row window with the global pads (top, bottom), and the
  pads that remain at the image's edges: the first shard keeps the top pad, the last
  the bottom one, and the others get rows of their neighbours instead. A halo may be
  wider than a shard (SPP's 13-window on 5-row shards): it then reaches past the
  nearest shard. A gathered output takes every row of a split input.
- **The exchange** (``_HaloFetch``) is built from one collective, an all-gather over
  the space group of equal-shaped tensors: each shard sends its top T and bottom U
  rows (T, U the widest halo any shard needs from below and above it, or its whole
  shard where they cover it) and cuts the rows it needs out of what arrives. Its
  backward sends the gradient rows of the halo back the same way, and each owner
  adds them to its own rows' gradient.
- **Transports.** ``ThreadTransport``: the shards are host threads of one process
  (serving, ``parallel/inference.py``), which post their tensors on a board, meet at a
  barrier and read each other's (CUDA events order the streams; one barrier per
  exchange, the board's two rows used in turns). ``GroupTransport``:
  the shards are ranks of a process group (training, ``parallel/spatial.py``):
  ``dist.all_gather`` over the space subgroup. The same ``all_gather(t)`` contract.
- **Reductions over the image.** ``mean_hw`` (D0's squeeze-excitation) sums each
  shard's rows and all-gathers the sums, added in shard order so that every shard
  holds the same value; ``space_max`` (dynamic int8's activation absmax) the same with
  a maximum.
- **Gradients.** A gathered level carries *partial* gradients: each shard back-propagates
  what its own consumers need, and the parameters' gradients are summed over the
  space axis (``parallel/spatial.py``). So the exchange that gathers a level sends
  each shard's gradient of every row back to its owner, a BatchNorm over a gathered
  level reduces over the data axis alone (``stats_group``), and the heads gathered
  for a loss that every shard computes whole keep, in the backward, only the rows of
  their own (``gather_heads``). ``once_over_space`` keeps the gradient of a loss term
  every shard computes from the parameters alone (D0's l2) on one shard.

A shard is active in its own thread (``activated``); a process-wide one
(``activated(shard, process=True)``, training) is seen from every thread, so that the
backward's recompute under ``--remat`` finds it.
"""

import contextlib
import functools
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_LOCAL = threading.local()
_PROCESS = None


# ----------------------------------------------------------------- transports

class ThreadBoard:
    """Where S host threads of one forward meet: two rows of a slot per shard, used in
    turns, and a barrier. One barrier per exchange: exchange k posts in row k mod 2,
    and no shard posts in that row again (exchange k + 2) before every shard has
    passed exchange k + 1's barrier, that is, has read row k. A fresh board per
    forward; a shard that fails aborts it, so that the others stop too."""

    def __init__(self, size: int):
        self.rows = ([None] * size, [None] * size)
        self.barrier = threading.Barrier(size)

    def abort(self):
        self.barrier.abort()


class ThreadTransport:
    """Shard ``rank``'s side of a ``ThreadBoard``: ``all_gather(t)`` posts ``t`` (with a
    CUDA event on this thread's stream), waits for every shard, and returns their
    tensors in shard order on ``t``'s device, this stream made to wait for theirs."""

    def __init__(self, board: ThreadBoard, rank: int):
        self.board, self.rank, self.turn = board, rank, 0

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        board = self.board
        slots = board.rows[self.turn]
        self.turn ^= 1
        event = None
        if t.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(t.device))
        slots[self.rank] = (t, event)
        board.barrier.wait()
        out = []
        for j, (u, ready) in enumerate(slots):
            if j != self.rank and u.is_cuda:
                if u.device == t.device:
                    stream = torch.cuda.current_stream(t.device)
                    stream.wait_event(ready)
                    u.record_stream(stream)
                else:
                    with torch.cuda.device(u.device):
                        torch.cuda.current_stream().wait_event(ready)
                    u = u.to(t.device)
            out.append(u)
        return out


class GroupTransport:
    """``dist.all_gather`` over the space subgroup ``group`` (this process is shard
    ``rank`` of ``size``)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts


# ----------------------------------------------------------------- the shard

def level_heights(height: int, width: int):
    """``{width: global height}`` of the image's levels: the height itself for a
    square image, else the TF-SAME chain of halvings of (height, width)."""
    if height == width:
        return None
    heights = {}
    h, w = height, width
    while True:
        if heights.get(w, h) != h:
            raise ValueError(f"a {height} x {width} image has two levels {w} wide; split a "
                             "square image or one whose level widths differ")
        heights[w] = h
        if h == 1 and w == 1:
            return heights
        h, w = -(-h // 2), -(-w // 2)


class SpaceShard:
    """Shard ``rank`` of ``size`` of an image of ``height`` x ``width``, its
    ``transport``, and the groups a train-mode BatchNorm reduces over: ``stats`` (a
    ``collectives.DataGroup`` over data x space) for a split level (a gathered level
    reduces over the active data group)."""

    def __init__(self, rank: int, size: int, transport, height: int, width: int,
                 stats=None):
        self.rank, self.size, self.transport, self.stats = rank, size, transport, stats
        self.image = (height, width)
        self._heights = level_heights(height, width)

    def height_of(self, width: int) -> int:
        """The global height of a level ``width`` wide."""
        if self._heights is None:
            return width
        if width not in self._heights:
            raise ValueError(f"no level of a {self.image[0]} x {self.image[1]} image is "
                             f"{width} wide")
        return self._heights[width]

    def split(self, height: int) -> bool:
        """True where the shards divide a level of ``height`` rows (each holds its share;
        else every shard holds all of them)."""
        return height % self.size == 0


def active() -> Optional[SpaceShard]:
    """The shard of the forward running in this thread (or of the process's step)."""
    return getattr(_LOCAL, "shard", None) or _PROCESS


@contextlib.contextmanager
def activated(shard: Optional[SpaceShard], process: bool = False):
    """Run the block as ``shard``: in this thread, or (``process``) seen from every
    thread of the process, the backward's included."""
    global _PROCESS
    if process:
        previous, _PROCESS = _PROCESS, shard
    else:
        previous, _LOCAL.shard = getattr(_LOCAL, "shard", None), shard
    try:
        yield
    finally:
        if process:
            _PROCESS = previous
        else:
            _LOCAL.shard = previous


def global_height(x: torch.Tensor) -> int:
    """The global height of the NCHW level ``x`` (its own height outside a spatial
    forward)."""
    shard = active()
    return x.shape[2] if shard is None else shard.height_of(x.shape[3])


def is_split(x: torch.Tensor) -> bool:
    """True inside a spatial forward where ``x``'s level is split over the shards."""
    shard = active()
    return shard is not None and shard.split(shard.height_of(x.shape[3]))


# ----------------------------------------------------------------- plans

@dataclass(frozen=True)
class Plan:
    """What shard ``rank`` does for one row operation from a level of ``height`` rows
    to one of ``out_height``: it needs input rows ``[lo, hi)`` of the image (``top``
    and ``bottom`` more beyond its edges, the pads that remain) for its output rows
    ``out``; over a split input, ``segments`` say whose rows they are, and the
    exchange sends each shard's top ``T`` and bottom ``U`` rows (``whole``: all of
    them); in the backward, each shard's gradient of the ``up`` rows above and the
    ``down`` rows below its own."""

    rank: int
    size: int
    height: int
    split: bool
    lo: int
    hi: int
    top: int
    bottom: int
    out: Tuple[int, int]
    segments: Tuple[Tuple[int, int, int], ...]
    exchange: bool
    T: int
    U: int
    whole: bool
    up: int
    down: int


def _need(kind: tuple, o0: int, o1: int) -> Tuple[int, int]:
    """Input rows ``[a, b)`` (possibly beyond the image) of output rows ``[o0, o1)``."""
    if kind[0] == "window":       # ("window", k, stride, top pad)
        _, k, stride, top = kind
        return o0 * stride - top, (o1 - 1) * stride - top + k
    if kind[0] == "upsample":     # ("upsample", factor)
        return o0 // kind[1], (o1 - 1) // kind[1] + 1
    if kind[0] == "resize":       # ("resize", source rows of each output row)
        return kind[1][o0], kind[1][o1 - 1] + 1
    raise ValueError(kind)


@functools.lru_cache(maxsize=8192)
def plan(rank: int, size: int, height: int, out_height: int, kind: tuple) -> Plan:
    """The ``Plan`` of shard ``rank`` of ``size`` (a pure function of the geometry, so
    every shard takes the same collective path)."""
    split = height % size == 0
    out_split = out_height % size == 0

    def out_rows(r):
        if not out_split:
            return 0, out_height
        m = out_height // size
        return r * m, (r + 1) * m

    needs, edges = [], []
    for r in range(size):
        a, b = _need(kind, *out_rows(r))
        needs.append((max(a, 0), min(b, height)))
        edges.append((max(0, -a), max(0, b - height)))
    lo, hi = needs[rank]
    top, bottom = edges[rank]
    segments, exchange, whole = (), False, False
    T = U = up = down = 0
    if split:
        n = height // size
        ups = [max(0, r * n - lo_r) for r, (lo_r, _) in enumerate(needs)]
        downs = [max(0, hi_r - (r + 1) * n) for r, (_, hi_r) in enumerate(needs)]
        up, down = max(ups), max(downs)
        exchange = up > 0 or down > 0
        T, U = min(n, down), min(n, up)
        whole = T + U >= n
        segments = tuple((j, max(lo, j * n), min(hi, (j + 1) * n))
                         for j in range(lo // n, (hi - 1) // n + 1))
    return Plan(rank, size, height, split, lo, hi, top, bottom, out_rows(rank), segments,
                exchange, T, U, whole, up, down)


def _rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    return x[:, :, start:stop]


class _HaloFetch(torch.autograd.Function):
    """Rows ``[lo, hi)`` of a split level, from this shard's rows ``x`` and the others'
    (one all-gather); the backward returns each halo row's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, p: Plan, transport):
        n = p.height // p.size
        parts = None
        if p.exchange:
            sent = x if p.whole else torch.cat([_rows(x, 0, p.T), _rows(x, n - p.U, n)], 2)
            parts = transport.all_gather(sent)
        pieces = []
        for j, g0, g1 in p.segments:
            if j == p.rank:
                pieces.append(_rows(x, g0 - j * n, g1 - j * n))
                continue
            start = (g0 - j * n if p.whole or g0 < j * n + p.T
                     else p.T + g0 - ((j + 1) * n - p.U))
            pieces.append(_rows(parts[j], start, start + g1 - g0))
        ctx.p, ctx.transport = p, transport
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        ctx.channels_last = x.is_contiguous(memory_format=torch.channels_last)
        if len(pieces) == 1:
            return pieces[0]
        block = torch.cat(pieces, 2)
        return block.contiguous(memory_format=torch.channels_last) if ctx.channels_last \
            else block

    @staticmethod
    def backward(ctx, grad):
        p = ctx.p
        n = p.height // p.size
        r0, r1 = p.rank * n, (p.rank + 1) * n
        gx = grad.new_zeros(ctx.shape)
        if ctx.channels_last:
            gx = gx.contiguous(memory_format=torch.channels_last)
        own0, own1 = max(p.lo, r0), min(p.hi, r1)
        if own1 > own0:
            gx[:, :, own0 - r0:own1 - r0] += _rows(grad, own0 - p.lo, own1 - p.lo)
        if p.exchange:
            # this shard's gradient of the rows [r0 − up, r0) and [r1, r1 + down), zero
            # where it holds none; each owner adds the rows of its own from every shard
            shape = (grad.shape[0], grad.shape[1], p.up + p.down, grad.shape[3])
            halo = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
            if p.lo < r0:
                halo[:, :, p.up - (r0 - p.lo):p.up] = _rows(grad, 0, r0 - p.lo)
            if p.hi > r1:
                halo[:, :, p.up:p.up + p.hi - r1] = _rows(grad, r1 - p.lo, p.hi - p.lo)
            parts = ctx.transport.all_gather(halo)
            for i, part in enumerate(parts):
                if i == p.rank:
                    continue
                for start, offset, length in ((i * n - p.up, 0, p.up),
                                              ((i + 1) * n, p.up, p.down)):
                    g0, g1 = max(start, r0), min(start + length, r1)
                    if g1 > g0:
                        gx[:, :, g0 - r0:g1 - r0] += _rows(part, offset + g0 - start,
                                                           offset + g1 - start).to(grad.dtype)
        return gx, None, None


def fetch(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """Input rows ``[p.lo, p.hi)`` of the level ``x`` holds this shard's rows of."""
    if not p.split:
        return _rows(x, p.lo, p.hi)
    return _HaloFetch.apply(x, p, active().transport)


def _plan_for(x: torch.Tensor, out_height_of, kind) -> Plan:
    shard = active()
    height = shard.height_of(x.shape[3])
    return plan(shard.rank, shard.size, height, out_height_of(height), kind)


# ----------------------------------------------------------------- row operations

def window_rows(x: torch.Tensor, k: int, stride: int, top: int, bottom: int):
    """``(rows, top, bottom)`` for a k-row window at ``stride`` with the global row pads
    ``(top, bottom)``: outside a spatial forward ``x`` and the pads as given; inside,
    the input rows of this shard's output rows and the pads left at the image's edges
    (the rest of the window's reach is halo rows). The caller pads ``rows`` by the
    returned pads (zeros, or -inf for a max-pool) and runs the op without row pads."""
    if active() is None or (k == 1 and stride == 1):
        return x, top, bottom
    p = _plan_for(x, lambda h: (h + top + bottom - k) // stride + 1,
                  ("window", k, stride, top))
    return fetch(x, p), p.top, p.bottom


def upsample_rows(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest ``factor``x upsampling (``F.interpolate(scale_factor=factor)``) of this
    shard's rows."""
    if active() is None:
        return F.interpolate(x, scale_factor=factor, mode="nearest")
    p = _plan_for(x, lambda h: h * factor, ("upsample", factor))
    y = F.interpolate(fetch(x, p), scale_factor=factor, mode="nearest")
    start = p.out[0] - p.lo * factor
    return _rows(y, start, start + p.out[1] - p.out[0])


@functools.lru_cache(maxsize=256)
def _nearest_exact_sources(size: int, out: int) -> Tuple[int, ...]:
    """The source row of each of ``out`` rows of ``F.interpolate(mode="nearest-exact")``
    from ``size`` rows, as torch computes it."""
    index = torch.arange(size, dtype=torch.float32).view(1, 1, size, 1)
    return tuple(int(v) for v in
                 F.interpolate(index, size=(out, 1), mode="nearest-exact").flatten())


def resize_rows(x: torch.Tensor, size: int) -> torch.Tensor:
    """``F.interpolate(x, size=(size, size), mode="nearest-exact")`` on this shard's
    rows (``jax.image.resize``'s nearest)."""
    if active() is None:
        return F.interpolate(x, size=(size, size), mode="nearest-exact")
    shard = active()
    height = shard.height_of(x.shape[3])
    sources = _nearest_exact_sources(height, size)
    p = plan(shard.rank, shard.size, height, size, ("resize", sources))
    rows = torch.tensor([s - p.lo for s in sources[p.out[0]:p.out[1]]], device=x.device)
    y = fetch(x, p).index_select(2, rows)
    return F.interpolate(y, size=(y.shape[2], size), mode="nearest-exact")


class _SpaceSum(torch.autograd.Function):
    """The sum of every shard's ``t`` (added in shard order, so that every shard holds
    the same value); the backward sums the shards' gradients the same way."""

    @staticmethod
    def forward(ctx, t, transport):
        ctx.transport = transport
        return _ordered_sum(transport.all_gather(t.contiguous()), t.device)

    @staticmethod
    def backward(ctx, grad):
        return _ordered_sum(ctx.transport.all_gather(grad.contiguous()), grad.device), None


def _ordered_sum(parts, device):
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``x.mean(dim=(2, 3), keepdim=True)`` over the whole image: a split level's
    shards sum their rows (float32 or wider) and add the sums."""
    if not is_split(x):
        return x.mean(dim=(2, 3), keepdim=True)
    shard = active()
    acc = torch.promote_types(x.dtype, torch.float32)
    total = _SpaceSum.apply(x.sum(dim=(2, 3), keepdim=True, dtype=acc), shard.transport)
    count = shard.height_of(x.shape[3]) * x.shape[3]
    return (total / count).to(x.dtype)


def space_max(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The maximum of every shard's ``t`` where ``x``'s level is split (``t`` itself
    elsewhere); no gradient."""
    if not is_split(x):
        return t
    parts = active().transport.all_gather(t.detach().contiguous())
    return torch.stack([part.to(t.device) for part in parts]).amax(0)


def stats_group(x: torch.Tensor, data_group):
    """The group a train-mode BatchNorm of ``x`` reduces over: data x space where its
    level is split, else ``data_group`` (the active data group, or None)."""
    if data_group is not None and is_split(x):
        return active().stats
    return data_group


# ----------------------------------------------------------------- the heads

class _GatherRows(torch.autograd.Function):
    """The whole height (dim 1, NHWC) of a split level from every shard's rows; in
    the backward this shard's rows of the gradient, which every shard holds whole and
    alike (the loss over the gathered heads is computed on every shard)."""

    @staticmethod
    def forward(ctx, t, rank, transport):
        ctx.rows, ctx.rank = t.shape[1], rank
        return torch.cat([part.to(t.device) for part in transport.all_gather(t)], 1)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None


class _OwnRows(torch.autograd.Function):
    """A gathered level as it is; in the backward only this shard's share of its rows
    (``[r·H/S, (r+1)·H/S)``, rounded down) keeps its gradient, so that the shards' sum
    counts each row once."""

    @staticmethod
    def forward(ctx, t, rank, size):
        ctx.rank, ctx.size = rank, size
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        h = grad.shape[1]
        start, stop = ctx.rank * h // ctx.size, (ctx.rank + 1) * h // ctx.size
        out = torch.zeros_like(grad)
        out[:, start:stop] = grad[:, start:stop]
        return out, None, None


def gather_heads(outputs, shard: Optional[SpaceShard] = None):
    """Every NHWC tensor (dim ≥ 4) of a nested tuple/list/dict of outputs made whole
    along its height on every shard, for a loss each shard computes whole; other
    values as they are."""
    shard = shard or active()

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(one(v) for v in t)
        if not torch.is_tensor(t) or t.dim() < 4:
            return t
        if t.shape[1] == shard.height_of(t.shape[2]):
            return _OwnRows.apply(t, shard.rank, shard.size)
        return _GatherRows.apply(t.contiguous(), shard.rank, shard.transport)

    return one(outputs)


def once_over_space(t: torch.Tensor) -> torch.Tensor:
    """A loss term every shard computes whole from the parameters (not through the
    split forward): its gradient on shard 0 alone, its value on every shard."""
    shard = active()
    return t if shard is None or shard.rank == 0 else t.detach()
