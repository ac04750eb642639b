"""Activations of the zoo: Mish, LeakyReLU(0.1) and swish.

Port of ``tmv_tpu/ops/activations.py``. Elementwise; cuDNN and PyTorch's own
kernels run them, as XLA fused them on the TPU.
"""

import torch
import torch.nn.functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish: ``x * tanh(softplus(x))``."""
    return F.mish(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish / SiLU: ``x * sigmoid(x)``."""
    return F.silu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU with the Darknet default slope of 0.1."""
    return F.leaky_relu(x, negative_slope=negative_slope)
