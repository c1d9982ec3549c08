"""A minimal, dependency-free config node with yacs-compatible semantics:
attribute access, YAML merge, dotted-key CLI override lists, freezing and
cloning, with yacs' type-checking rules.  A copy of the JAX package's
``config/node.py``, so the port reads the same YAML files and overrides
without importing that package.
"""

from __future__ import annotations

import copy
import ast
from typing import Any, List

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """Dict with attribute access, freeze/clone, and YAML/CLI merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        dict.__setitem__(self, name, value)

    # -- mutability ----------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            if isinstance(v, CfgNode):
                dict.__setitem__(out, k, v.clone())
            else:
                dict.__setitem__(out, k, copy.deepcopy(v))
        return out

    # -- merging -------------------------------------------------------------
    def merge_from_file(self, filename: str) -> None:
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(CfgNode(loaded), allow_new=False)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other, allow_new=False)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            node = self
            parts = full_key.split(".")
            for sub in parts[:-1]:
                assert sub in node, f"Non-existent key: {full_key}"
                node = node[sub]
            key = parts[-1]
            assert key in node, f"Non-existent key: {full_key}"
            value = _decode_value(v)
            value = _check_and_coerce(value, node[key], full_key)
            dict.__setitem__(node, key, value)

    def _merge_dict(self, other: "CfgNode", allow_new: bool) -> None:
        for k, v in other.items():
            if k not in self:
                if not allow_new:
                    raise KeyError(f"Non-existent config key: {k}")
                dict.__setitem__(self, k, v)
                continue
            if isinstance(self[k], CfgNode) and isinstance(v, (dict, CfgNode)):
                self[k]._merge_dict(CfgNode(v) if not isinstance(v, CfgNode) else v,
                                    allow_new)
            else:
                dict.__setitem__(self, k, _check_and_coerce(v, self[k], k))

    # -- pretty print ----------------------------------------------------------
    def __str__(self) -> str:
        def _indent(s, n):
            lines = s.split("\n")
            return "\n".join(lines[:1] + [" " * n + l for l in lines[1:]])

        out = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                out.append(f"{k}:\n{_indent(str(v), 2)}" if len(v) else f"{k}:")
            else:
                out.append(f"{k}: {v}")
        return "\n".join(out)

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"

    def dump(self) -> str:
        """Serialize to a YAML string (plain dicts)."""
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, CfgNode):
                out[k] = v.to_dict()
            elif isinstance(v, tuple):
                out[k] = list(v)
            else:
                out[k] = v
        return out


def _decode_value(v: Any) -> Any:
    """Decode a CLI override string into a Python value (yacs behavior)."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce(replacement: Any, original: Any, key: str) -> Any:
    """Allow the same type-coercions yacs does (list<->tuple, int->float)."""
    if isinstance(replacement, dict) and not isinstance(replacement, CfgNode):
        replacement = CfgNode(replacement)
    if original is None or replacement is None:
        return replacement
    o_t, r_t = type(original), type(replacement)
    if o_t is r_t:
        return replacement
    casts = [(tuple, list), (list, tuple), (int, float)]
    for src, dst in casts:
        if r_t is src and o_t is dst:
            return dst(replacement)
    if isinstance(replacement, _VALID_TYPES) and isinstance(original, _VALID_TYPES):
        # bool stored where int expected and similar research-config looseness
        if isinstance(original, (int, float)) and isinstance(replacement, (int, float)):
            return replacement
        if isinstance(original, str) or isinstance(replacement, str):
            return replacement
    raise ValueError(
        f"Type mismatch ({o_t} vs {r_t}) for config key {key}: "
        f"{original} vs {replacement}"
    )
