"""Attr-dict config system with ``k=v`` / YAML override.

The port's own copy of ``tmv_tpu/core/config.py`` (the ``Config`` class and the
parse helpers it needs), so that ``models/efficientdet/config.py`` builds its
D0–D7x configs without importing the JAX package. Nested attribute access,
recursive update, ``override()`` that rejects unknown keys, parsing of
``x.y=1,x.z=2`` strings, YAML load and save, and hashable ``frozen()`` snapshots.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, Mapping

try:
    import yaml
except ImportError:  # pragma: no cover - only the YAML methods need it
    yaml = None


def eval_str_fn(val: str):
    """Parse a config value string into a Python literal when possible."""
    if val in ("true", "false"):
        return val == "true"
    try:
        return ast.literal_eval(val)
    except (ValueError, SyntaxError):
        return val


def _parse_kv_string(config_str: str) -> Dict[str, Any]:
    """Parse 'x.y=1,x.z=2' into {'x': {'y': 1, 'z': 2}}."""
    out: Dict[str, Any] = {}
    for kv_pair in config_str.split(","):
        if not kv_pair:
            continue
        key_str, _, value_str = kv_pair.partition("=")
        if not _:
            raise ValueError(f"Invalid config_str fragment: {kv_pair!r}")
        node = out
        keys = key_str.strip().split(".")
        for k in keys[:-1]:
            nxt = node.get(k)
            if not isinstance(nxt, dict):
                nxt = {}
                node[k] = nxt
            node = nxt
        node[keys[-1]] = eval_str_fn(value_str)
    return out


class Config:
    """Nested attribute-style configuration container."""

    def __init__(self, config_dict: Mapping[str, Any] | None = None):
        if config_dict:
            self.update(config_dict)

    # -- attribute / item protocol ------------------------------------------------
    def __setattr__(self, k: str, v: Any):
        self.__dict__[k] = Config(v) if isinstance(v, dict) else copy.deepcopy(v)

    def __getattr__(self, k: str):
        try:
            return self.__dict__[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __getitem__(self, k: str):
        return self.__dict__[k]

    def __setitem__(self, k: str, v: Any):
        self.__setattr__(k, v)

    def __contains__(self, k: str) -> bool:
        return k in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def __repr__(self):
        return repr(self.as_dict())

    def __str__(self):
        if yaml is None:
            return str(self.as_dict())
        try:
            return yaml.dump(self.as_dict(), indent=4)
        except TypeError:
            return str(self.as_dict())

    def __eq__(self, other):
        if isinstance(other, Config):
            return self.as_dict() == other.as_dict()
        if isinstance(other, dict):
            return self.as_dict() == other
        return NotImplemented

    # -- updates ------------------------------------------------------------------
    def _update(self, config_dict: Mapping[str, Any], allow_new_keys: bool):
        if not config_dict:
            return
        for k, v in config_dict.items():
            if k not in self.__dict__:
                if not allow_new_keys:
                    raise KeyError(f"Key `{k}` does not exist for overriding.")
                self.__setattr__(k, v)
            else:
                cur = self.__dict__[k]
                if isinstance(cur, Config) and isinstance(v, dict):
                    cur._update(v, allow_new_keys)
                elif isinstance(cur, Config) and isinstance(v, Config):
                    cur._update(v.as_dict(), allow_new_keys)
                else:
                    self.__setattr__(k, v)

    def update(self, config_dict: Mapping[str, Any]):
        """Recursive update; new keys allowed."""
        self._update(config_dict, allow_new_keys=True)

    def override(self, config_dict_or_str, allow_new_keys: bool = False):
        """Recursive update from dict / 'k=v,…' string / *.yaml path.

        Unknown keys raise `KeyError` unless `allow_new_keys`.
        """
        if isinstance(config_dict_or_str, str):
            if not config_dict_or_str:
                return
            if "=" in config_dict_or_str:
                config_dict = _parse_kv_string(config_dict_or_str)
            elif config_dict_or_str.endswith((".yaml", ".yml")):
                config_dict = self.parse_from_yaml(config_dict_or_str)
            else:
                raise ValueError(
                    f"Invalid string {config_dict_or_str!r}: "
                    "must end with .yaml or contain '='."
                )
        elif isinstance(config_dict_or_str, (dict, Config)):
            config_dict = config_dict_or_str
            if isinstance(config_dict, Config):
                config_dict = config_dict.as_dict()
        else:
            raise ValueError(f"Unknown value type: {config_dict_or_str!r}")
        self._update(config_dict, allow_new_keys)

    # -- misc accessors -------------------------------------------------------------
    def get(self, k, default_value=None):
        return self.__dict__.get(k, default_value)

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def as_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = v.as_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def frozen(self):
        """Hashable immutable snapshot (tuples of sorted items, recursively)."""

        def _freeze(v):
            if isinstance(v, Config):
                return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
            if isinstance(v, dict):
                return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
            if isinstance(v, (list, tuple)):
                return tuple(_freeze(x) for x in v)
            return v

        return _freeze(self)

    # -- YAML ------------------------------------------------------------------------
    @staticmethod
    def parse_from_yaml(yaml_file_path: str) -> Dict[Any, Any]:
        if yaml is None:
            raise RuntimeError("pyyaml unavailable")
        with open(yaml_file_path, "r") as f:
            return yaml.load(f, Loader=yaml.FullLoader)

    def save_to_yaml(self, yaml_file_path: str):
        if yaml is None:
            raise RuntimeError("pyyaml unavailable")
        with open(yaml_file_path, "w") as f:
            yaml.dump(self.as_dict(), f, default_flow_style=False)

    def parse_from_str(self, config_str: str) -> Dict[Any, Any]:
        if not config_str:
            return {}
        return _parse_kv_string(config_str)
