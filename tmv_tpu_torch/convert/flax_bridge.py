"""Flax variables → PyTorch ``state_dict``.

Every converter of the JAX package (Darknet ``.weights``, Keras ``.h5``, orbax
checkpoints) ends in the same flax tree ``{"params": …, "batch_stats": …}``, so
this one bridge loads all of them. The port's modules carry the flax names, so
the bridge is a walk over paths, not a table:

- conv kinds — ``Conv_k``, and EfficientDet's ``conv2d``, ``depthwise`` and
  ``pointwise`` — map ``…/kernel`` (HWIO) → ``….weight`` (OIHW); a depthwise
  kernel ``(k, k, 1, C)`` becomes ``(C, 1, k, k)`` by the same transpose;
- ``…/Dense_k/kernel`` ``(in, out)`` → ``….Dense_k.weight`` ``(out, in)``;
- ``…/bias`` of a conv or Dense as is;
- BatchNorm kinds — ``BatchNorm_k``, and EfficientDet's ``bn`` and
  ``bn_{i}_level_{l}`` — map ``{scale, bias}`` + ``batch_stats …/{mean, var}``
  → ``weight``/``bias``/``running_mean``/``running_var``, plus
  ``num_batches_tracked`` = 0 (Keras BN: epsilon 1e-3 and momentum 0.99, which
  the port's modules set as torch ``eps=1e-3, momentum=0.01``);
- a BiFPN fusion weight ``…/BiFPNNode_j/WSM_i`` (a scalar or ``(C,)`` param
  directly under the node) → the parameter ``….BiFPNNode_j.WSM_i``.

It raises on a leaf it does not know and on two leaves that land on one key.
Given a ``model``, it also checks that the keys are exactly the model's and the
shapes match.
"""

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


_CONV_KINDS = {"Conv", "conv2d", "depthwise", "pointwise"}
_BN_KINDS = {"BatchNorm", "bn"}
_BN_PER_LEVEL = re.compile(r"bn_\d+_level_\d+")


def _kind(module_name: str) -> str:
    """``Conv``, ``BatchNorm`` or the module's class name without its ``_k``."""
    if _BN_PER_LEVEL.fullmatch(module_name):
        return "BatchNorm"
    base = re.sub(r"_\d+$", "", module_name)
    if base in _CONV_KINDS:
        return "Conv"
    if base in _BN_KINDS:
        return "BatchNorm"
    return base


def _map_leaf(collection: str, path) -> tuple:
    """(torch key, transform) of one flax leaf, or raise."""
    *modules, leaf = path
    if not modules:
        raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no module")
    kind = _kind(modules[-1])
    stem = ".".join(modules)
    if collection == "params":
        if kind == "Conv" and leaf == "kernel":
            return f"{stem}.weight", lambda a: a.transpose(3, 2, 0, 1)
        if kind == "Dense" and leaf == "kernel":
            return f"{stem}.weight", lambda a: a.T
        if kind in ("Conv", "Dense") and leaf == "bias":
            return f"{stem}.bias", None
        if kind == "BatchNorm" and leaf in _BN_PARAMS:
            return f"{stem}.{_BN_PARAMS[leaf]}", None
        if kind == "BiFPNNode" and re.fullmatch(r"WSM_\d+", leaf):
            return f"{stem}.{leaf}", None
    elif collection == "batch_stats":
        if kind == "BatchNorm" and leaf in _BN_STATS:
            return f"{stem}.{_BN_STATS[leaf]}", None
    raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no torch counterpart")


def flax_to_state_dict(variables: Mapping[str, Any],
                       model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Map ``{"params": …, "batch_stats": …}`` (nested dicts of arrays) to a
    ``state_dict``. Every leaf is consumed exactly once or the call raises."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"flax collections without a torch counterpart: {sorted(unknown)}")
    state: Dict[str, torch.Tensor] = {}
    source: Dict[str, str] = {}
    bn_modules = set()
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            key, transform = _map_leaf(collection, path)
            where = f"{collection}/{'/'.join(path)}"
            if key in state:
                raise KeyError(f"{where} and {source[key]} both map to {key}")
            array = np.asarray(value, dtype=np.float32)
            if transform is not None:
                array = transform(array)
            state[key] = torch.tensor(np.array(array, order="C"))  # keeps 0-d leaves 0-d
            source[key] = where
            if _kind(path[-2]) == "BatchNorm":
                bn_modules.add(key.rsplit(".", 1)[0])
    for stem in sorted(bn_modules):
        for name in ("weight", "bias", "running_mean", "running_var"):
            if f"{stem}.{name}" not in state:
                raise KeyError(f"BatchNorm {stem} lacks {name} in the flax tree")
        state[f"{stem}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    if model is not None:
        _check_against(state, model)
    return state


def _check_against(state: Mapping[str, torch.Tensor], model: torch.nn.Module):
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"bridge/model key mismatch: missing {missing[:5]} "
                       f"({len(missing)}), unexpected {extra[:5]} ({len(extra)})")
    for key, tensor in state.items():
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: flax shape {tuple(tensor.shape)} vs "
                             f"torch {tuple(expected[key].shape)}")
