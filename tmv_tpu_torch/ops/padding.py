"""TF-SAME padding arithmetic, shared by the layers and the kernel wrappers."""

from typing import Tuple


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-SAME (before, after) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2
