"""Flax variables → PyTorch ``state_dict``.

Every converter of the JAX package (Darknet ``.weights``, Keras ``.h5``, orbax
checkpoints) ends in the same flax tree ``{"params": …, "batch_stats": …}``, so
this one bridge loads all of them. The port's modules carry the flax names, so
the bridge is a walk over paths, not a table:

- conv kinds — ``Conv_k``, EfficientDet's ``conv2d``, ``depthwise`` and
  ``pointwise``, ResNet50V2's stem ``conv1`` (its ``conv2``…``conv5`` are
  stacks, not convs), and RepVGG's ``conv`` and ``rbr_reparam`` — map
  ``…/kernel`` (HWIO) → ``….weight`` (OIHW); a depthwise kernel ``(k, k, 1, C)``
  becomes ``(C, 1, k, k)`` and a grouped one ``(k, k, C/g, O)`` becomes
  ``(O, C/g, k, k)`` by the same transpose;
- ``…/Dense_k/kernel`` (and RepVGG's ``dense``) ``(in, out)`` → ``….weight``
  ``(out, in)``;
- ``…/bias`` of a conv or Dense as is;
- BatchNorm kinds — ``BatchNorm_k``, EfficientDet's ``bn`` and
  ``bn_{i}_level_{l}``, RepVGG's ``rbr_identity`` and ``AttentionConv2D``'s
  ``bn1`` — map ``{scale, bias}`` +
  ``batch_stats …/{mean, var}``
  → ``weight``/``bias``/``running_mean``/``running_var``, plus
  ``num_batches_tracked`` = 0 (Keras BN: epsilon 1e-3 and momentum 0.99, which
  the port's modules set as torch ``eps=1e-3, momentum=0.01``);
- a BiFPN fusion weight ``…/BiFPNNode_j/WSM_i`` (a scalar or ``(C,)`` param
  directly under the node) → the parameter ``….BiFPNNode_j.WSM_i``.

It raises on a leaf it does not know and on two leaves that land on one key.
Given a ``model``, it also checks that the keys are exactly the model's and the
shapes match.

``optax_adam_state_dict`` carries an optax Adam state (``ScaleByAdamState``,
also inside ``inject_hyperparams``) into a ``torch.optim.Adam`` state dict: its
moments ``mu``/``nu`` walk the same paths with the same layout transposes as
the parameters, so a JAX ``TrainState`` resumes in the port.
``optax_sgd_state_dict`` does the same for ``optax.sgd(…, momentum=…)``: the
``TraceState`` momentum ``trace`` becomes each parameter's ``momentum_buffer``
of a ``torch.optim.SGD`` (the step count lives in the train state, the learning
rate in its schedule).

``state_dict_to_flax`` is the way back: a port ``state_dict`` → the flax tree, so
that a checkpoint of the port's trainers is scored by the JAX package
(``tools/torch_checkpoint_to_flax.py``).

``quant_from_flax`` maps the JAX ``quant`` collection of static int8 (HWIO
``kernel_q``, scalar or per-channel ``in_absmax``, ``w_absmax`` per site, at the
paths of ``tmv_tpu/quant/static.py``) onto the port's non-persistent site buffers
(``quant/static.py::install_site``), and ``quant_stats_from_flax`` a JAX
``quant_stats`` calibration tree onto the flat dict the port's
``calibrate_model`` returns, so that both packages can be prepared from one
calibration.

``moco_state_from_flax`` maps a JAX ``MocoState`` (``TrainState.extra`` of the
MoCo trainer) onto the port's: the key tower's params and ``batch_stats`` into
the key module, the queue and the pointer as they are.
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
# modules given an explicit name: ResNet50V2's stem; RepVGG's convs, identity and
# head; AttentionConv2D's convs and BatchNorm
_NAMED = {"conv1": "Conv", "conv": "Conv", "rbr_reparam": "Conv",
          "rbr_identity": "BatchNorm", "dense": "Dense", "bn1": "BatchNorm", "conv2": "Conv",
          "W1_1": "Conv", "W1_2": "Conv", "V1": "Conv", "W2_1": "Conv", "W2_2": "Conv",
          "V2": "Conv"}
_BN_KINDS = {"BatchNorm", "bn"}
_BN_PER_LEVEL = re.compile(r"bn_\d+_level_\d+")


def _kind(module_name: str) -> str:
    """``Conv``, ``BatchNorm`` or the module's class name without its ``_k``."""
    if _BN_PER_LEVEL.fullmatch(module_name):
        return "BatchNorm"
    if module_name in _NAMED:
        return _NAMED[module_name]
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


def _convert(collection: str, tree: Mapping[str, Any], state: Dict[str, torch.Tensor],
             source: Dict[str, str]):
    """Map every leaf of one collection into ``state``; returns the stems of the
    BatchNorm modules met."""
    bn_modules = set()
    for path, value in _leaves(tree):
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
    return bn_modules


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
        bn_modules |= _convert(collection, variables.get(collection, {}), state, source)
    for stem in sorted(bn_modules):
        for name in ("weight", "bias", "running_mean", "running_var"):
            if f"{stem}.{name}" not in state:
                raise KeyError(f"BatchNorm {stem} lacks {name} in the flax tree")
        state[f"{stem}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    if model is not None:
        _check_against(state, model)
    return state


_BN_FROM_TORCH = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                  "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """The reverse of ``flax_to_state_dict``: a ``state_dict`` → ``{"params": …,
    "batch_stats": …}`` nested dicts of float32 numpy arrays in flax's layouts (OIHW
    conv weights back to HWIO, Dense weights transposed, BatchNorm buffers to
    ``batch_stats``; ``num_batches_tracked`` has no flax counterpart and is dropped).
    It needs no jax. Raises on a key it does not know."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, tensor in state.items():
        *modules, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        kind = _kind(modules[-1]) if modules else None
        array = tensor.detach().cpu().float().numpy()
        if kind == "Conv" and leaf == "weight":
            collection, name, array = "params", "kernel", array.transpose(2, 3, 1, 0)
        elif kind == "Dense" and leaf == "weight":
            collection, name, array = "params", "kernel", array.T
        elif kind in ("Conv", "Dense") and leaf == "bias":
            collection, name = "params", "bias"
        elif kind == "BatchNorm" and leaf in _BN_FROM_TORCH:
            collection, name = _BN_FROM_TORCH[leaf]
        elif kind == "BiFPNNode" and re.fullmatch(r"WSM_\d+", leaf):
            collection, name = "params", leaf
        else:
            raise KeyError(f"torch key {key} has no flax counterpart")
        node = out[collection]
        for module in modules:
            node = node.setdefault(module, {})
        node[name] = np.array(array, order="C")  # keeps 0-d leaves 0-d
    return out


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


def _find_adam(opt_state):
    """(ScaleByAdamState-like node, learning rate or None) inside an optax state."""
    lr = None
    hyper = getattr(opt_state, "hyperparams", None)
    if isinstance(hyper, Mapping) and "learning_rate" in hyper:
        lr = float(np.asarray(hyper["learning_rate"]))
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state, lr
    children = (opt_state.inner_state,) if hasattr(opt_state, "inner_state") else opt_state
    if isinstance(children, (tuple, list)):
        for child in children:
            found, inner_lr = _find_adam(child)
            if found is not None:
                return found, lr if lr is not None else inner_lr
    return None, lr


def _find_field(opt_state, field: str):
    """The first state node (a NamedTuple) of an optax state (nested tuples,
    ``inner_state``) with the field ``field``, or None."""
    if field in getattr(opt_state, "_fields", ()):
        return opt_state
    children = (opt_state.inner_state,) if hasattr(opt_state, "inner_state") else opt_state
    if isinstance(children, (tuple, list)):
        for child in children:
            found = _find_field(child, field)
            if found is not None:
                return found
    return None


def _moments_by_param(tree, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """``[(index, parameter, moment)]`` of a params-shaped optax tree mapped onto
    the optimizer's parameters; raises where the two sets differ."""
    mapped: Dict[str, torch.Tensor] = {}
    _convert("params", tree, mapped, {})
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if sorted(names[id(p)] for p in params) != sorted(mapped):
        raise KeyError("the optax moments and the optimizer's parameters differ")
    return [(i, p, mapped[names[id(p)]].to(p.dtype)) for i, p in enumerate(params)]


def optax_sgd_state_dict(opt_state, model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """A ``state_dict`` for ``optimizer`` (a ``torch.optim.SGD`` with momentum
    over ``model``'s parameters) holding the optax SGD state ``opt_state``: the
    momentum ``trace`` as each parameter's ``momentum_buffer``. Raises where a
    buffer has no parameter or a parameter no buffer."""
    trace = _find_field(opt_state, "trace")
    if trace is None:
        raise KeyError("no optax TraceState (momentum trace) in the optimizer state")
    out = optimizer.state_dict()
    out["state"] = {i: {"momentum_buffer": m}
                    for i, _, m in _moments_by_param(trace.trace, model, optimizer)}
    return out


def optax_adam_state_dict(opt_state, model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """A ``state_dict`` for ``optimizer`` (a ``torch.optim.Adam`` over
    ``model``'s parameters) holding the optax Adam state ``opt_state``: the
    step count, the moments mapped onto each parameter, and the live learning
    rate of an ``inject_hyperparams`` state. Raises where a moment has no
    parameter or a parameter no moment."""
    adam, lr = _find_adam(opt_state)
    if adam is None:
        raise KeyError("no optax ScaleByAdamState (count, mu, nu) in the optimizer state")
    mu = _moments_by_param(adam.mu, model, optimizer)
    nu = _moments_by_param(adam.nu, model, optimizer)
    out = optimizer.state_dict()
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    out["state"] = {i: {"step": step.clone(), "exp_avg": m, "exp_avg_sq": v}
                    for (i, _, m), (_, _, v) in zip(mu, nu)}
    if lr is not None:
        for group in out["param_groups"]:
            group["lr"] = lr
    return out


def moco_state_from_flax(moco_state, key_model: torch.nn.Module):
    """A ``models.moco.MocoState`` from JAX's (``key_params``,
    ``key_batch_stats``, ``queue``, ``queue_ptr``): the key tower's variables
    loaded strictly into ``key_model`` (on its device), the queue and pointer
    as they are."""
    from tmv_tpu_torch.models.moco import MocoState

    device = next(key_model.parameters()).device
    state = flax_to_state_dict({"params": moco_state.key_params,
                                "batch_stats": moco_state.key_batch_stats}, key_model)
    key_model.load_state_dict(state, strict=True)
    for p in key_model.parameters():
        p.requires_grad_(False)
    queue = torch.tensor(np.asarray(moco_state.queue, np.float32), device=device)
    return MocoState(key_model, queue, int(np.asarray(moco_state.queue_ptr)))


_QUANT_LEAF = re.compile(r"(in_absmax|kernel_q|w_absmax)(_\w+)?")


def quant_stats_from_flax(stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``quant_stats`` tree (``calibrate_model``'s) → the port's
    ``{module.path.in_absmax[_conv]: absmax}``; 1-tuples from older flax are
    unwrapped."""
    out = {}
    for path, value in _leaves(stats):
        if isinstance(value, (tuple, list)):
            value = value[0]
        out[".".join(path)] = np.asarray(value, np.float32)
    return out


def quant_from_flax(variables: Mapping[str, Any], model: torch.nn.Module) -> torch.nn.Module:
    """Install the ``quant`` collection of ``variables`` (from
    ``prepare_static_int8_variables``) into ``model``'s int8 sites → ``model``."""
    from tmv_tpu_torch.quant.static import install_site

    sites: Dict[tuple, Dict[str, Any]] = {}
    for path, value in _leaves(variables["quant"]):
        *modules, leaf = path
        found = _QUANT_LEAF.fullmatch(leaf)
        if not found:
            raise KeyError(f"quant leaf {'/'.join(path)} has no torch counterpart")
        suffix = found.group(2) or ""
        sites.setdefault((".".join(modules), suffix), {})[found.group(1)] = np.asarray(value)
    for (module_path, suffix), leaves in sites.items():
        if set(leaves) != {"in_absmax", "kernel_q", "w_absmax"}:
            raise KeyError(f"quant site {module_path}{suffix} lacks "
                           f"{sorted({'in_absmax', 'kernel_q', 'w_absmax'} - set(leaves))}")
        install_site(model.get_submodule(module_path), suffix, leaves["in_absmax"],
                     leaves["kernel_q"], leaves["w_absmax"])
    return model
