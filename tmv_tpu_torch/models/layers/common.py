"""Shared conv building blocks (NCHW inside, ``channels_last`` memory).

Port of ``tmv_tpu/models/layers/common.py``. Submodules carry the flax auto-names
(``DarknetConv_0/Conv_0``, ``BatchNorm_0``) so that ``convert.flax_bridge`` maps
a flax tree onto them by path.

- Darknet stride-2 convs pad top-left ``((1, 0), (1, 0))`` and run VALID.
- Every other conv pads TF-SAME explicitly (torch's ``padding='same'`` refuses
  stride 2); the SPP max-pool pads SAME with -inf.
- BatchNorm is Keras's: epsilon 1e-3, momentum 0.99 (torch ``momentum=0.01``).
  In train mode it normalizes by the batch statistics and updates its running
  statistics as flax does, with the *biased* batch variance (``BatchNorm``).
- ``dtype`` is the type the conv weights are held in; a conv computes in the
  type of its input and casts its weights to it (a no-op where they agree, as
  in the bf16 predictors). So a model with float32 weights fed bf16 activations
  trains on float32 master weights, as flax's ``param_dtype`` float32 with
  ``dtype`` bf16 does. BatchNorm parameters and statistics stay float32.
- ``remat_call`` runs a stage under ``torch.utils.checkpoint`` (non-reentrant)
  in train mode, the port of flax's ``nn.remat`` on the same stages: the
  backward recomputes the stage's interior instead of storing it. The
  recompute neither updates the BatchNorm statistics a second time nor draws
  other numbers from the explicit generators the stage draws from.
- ``ConvBN`` in eval mode under ``quant.quantized("int8")`` runs its conv as a
  dynamic-int8 conv, under ``"int8_static"`` as the site ``prepare_static_int8``
  baked, both with the BN affine folded into the dequant (the stride-2 conv keeps
  the top-left pad and VALID); the float32 result is cast to the input's type (in
  the kernel's epilogue), then activated. Under ``"calib"`` it records its input's
  range. Train mode ignores the mode.
"""

import contextlib
import math
import threading
from typing import Callable, Dict, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from tmv_tpu_torch.ops.activations import leaky_relu, mish, swish
from tmv_tpu_torch.parallel import halo
from tmv_tpu_torch.parallel.collectives import active as data_group, global_batch_norm
from tmv_tpu_torch.ops.padding import same_pads
from tmv_tpu_torch.quant.dynamic import dynamic_int8_conv, quant_mode
from tmv_tpu_torch.quant.static import bn_affine, record, static_conv_site

ACTIVATIONS: Dict[str, Callable] = {"leaky": leaky_relu, "mish": mish, "swish": swish,
                                    "linear": lambda x: x}


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """True while a ``remat_call`` stage is being recomputed for its backward."""
    return getattr(_RECOMPUTE, "depth", 0) > 0


def remat_call(remat: bool, module: nn.Module, *args,
               generators: Sequence[torch.Generator] = ()):
    """``module(*args)``; with ``remat`` in train mode (and autograd on) through
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, whose
    non-reentrant form also keeps the gradient of a stage whose inputs and
    parameters need none (the Darknet warm-up's frozen stages). The recompute
    runs with ``recomputing()`` true, so ``BatchNorm`` updates its statistics
    once per step, as under flax's ``nn.remat``; each of ``generators`` (the
    explicit ``torch.Generator`` s the stage draws from, which checkpoint does not
    restore) is put back to its state at the forward for the recompute and
    returned to its later state after it."""
    if not (remat and module.training and torch.is_grad_enabled()):
        return module(*args)

    def contexts():
        at_forward = [g.get_state() for g in generators]

        @contextlib.contextmanager
        def recompute():
            now = [g.get_state() for g in generators]
            for g, state in zip(generators, at_forward):
                g.set_state(state)
            _RECOMPUTE.depth = getattr(_RECOMPUTE, "depth", 0) + 1
            try:
                yield
            finally:
                _RECOMPUTE.depth -= 1
                for g, state in zip(generators, now):
                    g.set_state(state)

        return contextlib.nullcontext(), recompute()

    return torch.utils.checkpoint.checkpoint(module, *args, use_reentrant=False,
                                             context_fn=contexts)


def _pair(v: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias=None,
                stride: Union[int, Tuple[int, int]] = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with TF-SAME padding; an asymmetric pad is applied explicitly. In a
    height-sharded forward the row pads are the global height's, and the shard's rows
    come with their halo (``parallel.halo.window_rows``)."""
    stride = _pair(stride)
    (top, bottom), (left, right) = (same_pads(halo.global_height(x), weight.shape[2], stride[0]),
                                    same_pads(x.shape[3], weight.shape[3], stride[1]))
    x, top, bottom = halo.window_rows(x, weight.shape[2], stride[0], top, bottom)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, (top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride, groups=groups)


def as_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: ``t`` itself where it already is, so that a program traced
    by ``torch.export`` holds no cast (and no metadata check) for it."""
    return t if t.dtype == dtype else t.to(dtype)


def conv_as_input(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` with the weight and bias cast to x's type (a no-op where they
    agree); the conv's own padding, stride and groups."""
    bias = None if conv.bias is None else as_dtype(conv.bias, x.dtype)
    return F.conv2d(x, as_dtype(conv.weight, x.dtype), bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's type (``conv_as_input``), for the
    flax ``nn.Conv`` modules that are called as modules (ResNet50V2's); in a
    height-sharded forward its rows come with their halo."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if halo.active() is None:
            return conv_as_input(self, x)
        (k, _), (s, _), (ph, pw) = self.kernel_size, self.stride, self.padding
        x, top, bottom = halo.window_rows(x, k, s, ph, ph)
        bias = None if self.bias is None else as_dtype(self.bias, x.dtype)
        return F.conv2d(F.pad(x, (pw, pw, top, bottom)), as_dtype(self.weight, x.dtype), bias,
                        self.stride, 0, self.dilation, self.groups)


class DarknetConv(nn.Module):
    """Conv2D with Darknet padding semantics (no BN, optional bias)."""

    def __init__(self, in_features: int, filters: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.Conv_0 = nn.Conv2d(in_features, filters, self.kernel_size, self.strides,
                                bias=use_bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        weight = as_dtype(conv.weight, x.dtype)
        bias = None if conv.bias is None else as_dtype(conv.bias, x.dtype)
        if self.strides == (2, 2):
            # Darknet downsampling: top-left zero pad + VALID (a shard's halo from above)
            x, top, bottom = halo.window_rows(x, self.kernel_size[0], 2, 1, 0)
            return F.conv2d(F.pad(x, (1, 0, top, bottom)), weight, bias, self.strides)
        return conv2d_same(x, weight, bias, self.strides)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics as flax's
    ``nn.BatchNorm`` does: ``ra = m·ra + (1−m)·batch`` with the biased batch
    variance ``mean((x−μ)²)``, where torch would blend in the unbiased one. One
    fused ``F.batch_norm`` normalizes (biased variance in both) and, with momentum
    1 into scratch buffers, hands back the batch mean and unbiased variance,
    reduced in float32 also for bf16 inputs; the update rescales the variance by
    (n−1)/n. One value per channel (a 1 × 1 map of one image) normalizes to the
    bias with a batch variance of 0, as flax does, where ``F.batch_norm`` would
    refuse it. Eval mode is ``nn.BatchNorm2d``'s. While a ``remat_call`` stage is
    recomputed the statistics are left alone: they moved in the forward.

    Inside a data-parallel step (``parallel.collectives.active()``, at any world size)
    the batch statistics are the global batch's, as GSPMD reduces them in the JAX
    package: ``global_batch_norm`` all-reduces the sum, the sum of squares and the
    count in float32 and takes flax's variance ``mean(x²) − mean(x)²``; the running
    statistics take that biased variance. A recomputed stage issues the same
    all-reduce on every rank and again leaves the statistics alone. In a
    height-sharded step a split level's statistics are those of every rank's rows
    (data x space), a gathered level's the data group's (``parallel.halo.stats_group``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = data_group()
        if group is not None:
            y, mean, biased = global_batch_norm(x, self.weight, self.bias, self.eps,
                                                self.running_mean, self.running_var,
                                                halo.stats_group(x, group))
            if not recomputing():
                self._update_running(mean, biased)
            return y
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = torch.batch_norm(x, self.weight, self.bias, mean, var, True, 1.0, self.eps,
                             torch.backends.cudnn.enabled)
        if recomputing():
            return y
        n = x.numel() // x.shape[1]
        biased = var * ((n - 1) / n) if n > 1 else torch.zeros_like(var)
        self._update_running(mean, biased)
        return y

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, biased_var: torch.Tensor):
        # ra + (1-m)·(batch − ra) = m·ra + (1-m)·batch, with m flax's momentum
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(biased_var, self.momentum)
        self.num_batches_tracked.add_(1)


class ConvBN(nn.Module):
    """Conv → BatchNorm → activation (DarknetConv2D_BN_{Leaky,Mish} parity)."""

    def __init__(self, in_features: int, filters: int,
                 kernel_size: Union[int, Tuple[int, int]] = 3,
                 strides: Union[int, Tuple[int, int]] = 1, act: str = "leaky",
                 dtype: torch.dtype = torch.float32, device=None,
                 bn_momentum: float = 0.99, bn_epsilon: float = 1e-3):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.DarknetConv_0 = DarknetConv(in_features, filters, kernel_size, strides,
                                         use_bias=False, dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(filters, eps=bn_epsilon, momentum=1.0 - bn_momentum,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = quant_mode()
        if mode in ("int8", "int8_static") and not self.training:
            conv = self.DarknetConv_0
            # Darknet downsampling: top-left zero pad + VALID
            pads = (1, 1, 0, 0) if conv.strides == (2, 2) else "SAME"
            # the float32 result cast to x's type in the kernel's epilogue
            if mode == "int8_static":
                y = static_conv_site(self, "", x, conv.kernel_size, conv.strides[0], pads,
                                     out_dtype=x.dtype)
            else:
                y = dynamic_int8_conv(x, conv.Conv_0.weight, conv.strides[0], pads,
                                      *bn_affine(self.BatchNorm_0), out_dtype=x.dtype)
            return self.act(y)
        if mode == "calib":
            record(self, "in_absmax", x)
        return self.act(self.BatchNorm_0(self.DarknetConv_0(x)))


def max_pool_same(x: torch.Tensor, window: int, strides: int = 1) -> torch.Tensor:
    """MaxPool2D with SAME padding (SPP pools), padded with -inf."""
    (top, bottom), (left, right) = (same_pads(halo.global_height(x), window, strides),
                                    same_pads(x.shape[3], window, strides))
    x, top, bottom = halo.window_rows(x, window, strides, top, bottom)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def max_pool_padded(x: torch.Tensor, window: int, strides: int, pad: int) -> torch.Tensor:
    """``F.max_pool2d(x, window, strides, padding=pad)`` (-inf at every border)."""
    x, top, bottom = halo.window_rows(x, window, strides, pad, pad)
    x = F.pad(x, (pad, pad, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def subsample(x: torch.Tensor, strides: int) -> torch.Tensor:
    """``x[:, :, ::strides, ::strides]`` (flax's ``max_pool(x, (1, 1), strides)``)."""
    x, _, _ = halo.window_rows(x, 1, strides, 0, 0)
    return x[:, :, ::strides, ::strides]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """UpSampling2D(2), nearest."""
    return halo.upsample_rows(x, 2)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init as the JAX package's: He-uniform conv kernels, zero biases,
    identity BatchNorm. Values are drawn on the CPU from one ``torch.Generator``
    in module order, so a seed gives the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            limit = math.sqrt(6.0 / fan_in)
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            m.weight.copy_(w.uniform_(-limit, limit, generator=gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
