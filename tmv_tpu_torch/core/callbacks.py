"""Training-health callbacks: early stopping, LR on plateau, graceful shutdown.

Port of ``tmv_tpu/core/callbacks.py`` (the Keras ``EarlyStopping`` and
``ReduceLROnPlateau`` of the reference trainers, `yolo_v3/train.py:74-77`):
plain-Python monitors driven from the CLI loop. ``set_learning_rate`` writes the
live LR into a ``torch.optim`` optimizer's ``param_groups``, where the JAX
package rewrites an ``inject_hyperparams`` state.
"""

from typing import Optional

import torch


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set ``lr`` in every param group of ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


class EarlyStopping:
    """Stop when the monitored value hasn't improved for ``patience`` epochs."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0, mode: str = "min"):
        self.patience = patience
        self.min_delta = min_delta
        self.sign = 1.0 if mode == "min" else -1.0
        self.best: Optional[float] = None
        self.wait = 0
        self.stopped = False

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        v = self.sign * float(value)
        if self.best is None or v < self.best - self.min_delta:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped


class ReduceLROnPlateau:
    """Multiply an LR factor by ``factor`` after ``patience`` flat epochs."""

    def __init__(self, factor: float = 0.3, patience: int = 6, min_delta: float = 0.0,
                 min_lr: float = 1e-6, base_lr: float = 1.0, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.min_lr = min_lr
        self.base_lr = base_lr
        self.sign = 1.0 if mode == "min" else -1.0
        self.best: Optional[float] = None
        self.wait = 0
        self.scale = 1.0

    @property
    def lr(self) -> float:
        return max(self.base_lr * self.scale, self.min_lr)

    def update(self, value: float) -> float:
        """Feed the epoch metric; returns the current LR."""
        v = self.sign * float(value)
        if self.best is None or v < self.best - self.min_delta:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                if self.lr > self.min_lr:
                    self.scale *= self.factor
                self.wait = 0
        return self.lr


class GracefulShutdown:
    """Preemption-safe training: catch SIGTERM/SIGINT, finish the current step,
    checkpoint, exit cleanly. The handler only sets a flag; the loop polls
    ``requested`` at the step boundary and saves. The second signal restores the
    previous handler, so a stuck save can still be killed."""

    def __init__(self, signals=None):
        import signal as _signal

        self._signal = _signal
        self.requested = False
        self._prev = {}
        for sig in signals or (_signal.SIGTERM, _signal.SIGINT):
            try:
                self._prev[sig] = _signal.signal(sig, self._handle)
            except (ValueError, OSError):  # non-main thread / unsupported
                pass

    def _handle(self, sig, frame):
        self.requested = True
        if sig in self._prev:
            self._signal.signal(sig, self._prev[sig])

    def uninstall(self):
        for sig, prev in self._prev.items():
            try:
                self._signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}
