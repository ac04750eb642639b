"""Numbered step checkpoints with latest-step resume, written by ``torch.save``.

Port of ``tmv_tpu/core/checkpoint.py::CheckpointManager`` (orbax there). A
checkpoint ``<directory>/<step>.pt`` holds the module's ``state_dict``
(parameters and BatchNorm buffers), the optimizer's ``state_dict``, the step,
the shadow loss, the EMA tensors when present and the state's ``extra``
(``extra.state_dict()``, e.g. MoCo's key tower, queue and pointer). It is
written to a temporary name and renamed, so a process killed mid-save leaves
the last complete checkpoint. ``save(wait=False)`` copies the state to host
memory at once and writes the file on a background thread;
``wait_until_finished`` and ``close`` drain the writes. A save at a step already
saved is skipped, and only the newest ``max_to_keep`` checkpoints stay. A state
without an optimizer saves a weights-only checkpoint (``cli/convert_darknet.py``,
``cli/train_moco.py --mode export_k``); restoring it leaves the optimizer fresh.

In a data-parallel run (a ``torch.distributed`` group is up) every rank calls
``save`` and ``restore`` at the same steps: the state is gathered whole where it is
FSDP-sharded (``state.parallel.full_state``, a collective), rank 0 alone writes, in
the single-device format, and a barrier follows the write; which steps are saved is
decided from this manager's own saves (not from the directory, which another rank
may be writing), so every rank takes the same path. Every rank restores.

``load_weights`` is the inference CLIs' loader (``cli/serve.py``,
``cli/eval_map.py``), the JAX package's ``restore_weights``: a checkpoint
directory (its latest step) or a bare ``state_dict`` ``.pt``; ``read_weights``
returns that ``state_dict`` without a module (the MoCo fine-tune grafts it).
"""

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_NAME = re.compile(r"(\d+)\.pt")


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _to_host(obj):
    """A copy of ``obj`` (nested dicts/lists of tensors) in host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._last_saved_step: Optional[int] = None
        self._saved = set(self.all_steps())
        self._writer = ThreadPoolExecutor(1)
        self._pending: List[Future] = []

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _write(self, step: int, payload):
        tmp = self.path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def save(self, step: int, state, wait: bool = True):
        """Save ``state`` (a ``TrainState``) at ``step``; with ``wait=False`` the
        file is written in the background."""
        distributed = _distributed()
        saved = self._saved if distributed else set(self.all_steps())
        if step != self._last_saved_step and step not in saved:
            full = getattr(state.parallel, "full_state", None)
            whole = full(state) if full is not None else {
                "model": state.model.state_dict(),
                "optimizer": (None if state.optimizer is None
                              else state.optimizer.state_dict()),
                "ema_params": state.ema_params}
            if not distributed or dist.get_rank() == 0:
                payload = _to_host({
                    **whole,
                    "step": int(state.step),
                    "shadow_loss": state.shadow_loss,
                    "ema_batch_stats": state.ema_batch_stats,
                    "extra": None if state.extra is None else state.extra.state_dict(),
                })
                self._pending.append(self._writer.submit(self._write, step, payload))
            self._last_saved_step = step
            self._saved.add(step)
        if wait:
            self.wait_until_finished()
            if distributed:
                dist.barrier()

    def wait_until_finished(self):
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def _load(self, step: Optional[int]):
        self.wait_until_finished()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (default: the latest) into ``state``'s
        module and optimizer and set its step, shadow loss, EMA and ``extra``.
        Returns ``state``, unchanged where there is no checkpoint."""
        raw = self._load(step)
        if raw is None:
            return state
        device = next(state.model.parameters()).device
        state.model.load_state_dict(raw["model"], strict=True)
        if raw["optimizer"] is not None:
            state.optimizer.load_state_dict(raw["optimizer"])
        state.step = int(raw["step"])
        state.shadow_loss = raw["shadow_loss"].to(device)
        for name in ("ema_params", "ema_batch_stats"):
            if raw.get(name) is not None:
                setattr(state, name, {k: v.to(device) for k, v in raw[name].items()})
        if (raw.get("extra") is None) != (state.extra is None):
            raise KeyError("the checkpoint's extra state and the train state's differ")
        if state.extra is not None:
            state.extra.load_state_dict(raw["extra"])
        return state

    def restore_weights(self, model: torch.nn.Module, step: Optional[int] = None) -> Optional[int]:
        """Load only the module's weights (parameters and BatchNorm statistics)
        of the checkpoint at ``step`` (default: the latest), for the inference
        CLIs. Returns the checkpoint's step, or None where there is none."""
        raw = self._load(step)
        if raw is None:
            return None
        model.load_state_dict(raw["model"], strict=True)
        return int(raw["step"])

    def close(self):
        self.wait_until_finished()
        self._writer.shutdown()


def read_weights(model_path: str) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """``(state_dict, step)`` of ``model_path`` on the CPU: a checkpoint
    directory's latest step (the optimizer state is not returned) or a bare
    ``state_dict`` ``.pt`` (step None); raises for a directory without a
    checkpoint."""
    if not os.path.isdir(model_path):
        return torch.load(model_path, map_location="cpu", weights_only=True), None
    mgr = CheckpointManager(model_path)
    try:
        raw = mgr._load(None)
    finally:
        mgr.close()
    if raw is None:
        raise FileNotFoundError(f"{model_path} holds no checkpoint")
    return raw["model"], int(raw["step"])


def load_weights(model: torch.nn.Module, model_path: str) -> Optional[int]:
    """Load ``model_path`` into ``model`` strictly: a checkpoint directory of the
    port's trainers or ``cli/convert_darknet.py`` (its latest step; the
    optimizer state is not read), or a bare ``state_dict`` ``.pt``. Returns the
    checkpoint's step, None for a ``.pt``; raises for a directory without a
    checkpoint."""
    state, step = read_weights(model_path)
    model.load_state_dict(state, strict=True)
    return step
