"""YACS-style hierarchical config: the port's own copy of ``dafne_tpu/config``.

The merge behaviour and key names of the JAX package's ``CfgNode``, so the
recipes under ``configs/`` merge unchanged.  PyYAML is imported only where a
YAML file is read: the machines that run the port on the GPU do not ship
it.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, List


class CfgNode(dict):
    """A dict with attribute access and recursive merge."""

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        super().__setitem__(name, value)

    def merge_from_other(self, other: "CfgNode | Dict[str, Any]") -> None:
        for k, v in other.items():
            if k in self and isinstance(self[k], CfgNode) and isinstance(v, dict):
                self[k].merge_from_other(v)
            else:
                self[k] = v

    def merge_from_file(self, filename: str) -> None:
        """Merge a YAML file, honoring ``_BASE_`` inheritance chains; string
        leaves that parse as Python literals are decoded (YACS behavior)."""
        self.merge_from_other(_decode_tree(_load_yaml_with_base(filename)))

    def dump(self) -> str:
        """The tree as JSON, which YAML readers and ``merge_from_file`` accept
        (the machines that run the port need no PyYAML to write it)."""
        return json.dumps(self, indent=1, sort_keys=True)

    def dump_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump())

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge dotted KEY VALUE pairs."""
        if len(opts) % 2:
            raise ValueError(f"Override list must be key-value pairs: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = _decode_value(value, node.get(parts[-1]))


def _decode_value(value: Any, old: Any) -> Any:
    """Parse a string into a Python literal, coerced toward old's type."""
    if not isinstance(value, str):
        return value
    try:
        parsed = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        parsed = value
    if isinstance(old, bool) and isinstance(parsed, str):
        if parsed.lower() in ("true", "false"):
            parsed = parsed.lower() == "true"
    if isinstance(old, float) and isinstance(parsed, int):
        parsed = float(parsed)
    if isinstance(parsed, tuple):
        parsed = list(parsed)
    return parsed


def _decode_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _decode_tree(v) for k, v in tree.items()}
    return _decode_value(tree, None)


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    import yaml

    with open(filename, "r") as f:
        loaded = yaml.safe_load(f) or {}
    if "_BASE_" in loaded:
        base_file = loaded.pop("_BASE_")
        if not os.path.isabs(base_file):
            base_file = os.path.join(os.path.dirname(filename), base_file)
        merged = _load_yaml_with_base(base_file)
        _deep_update(merged, loaded)
        return merged
    return loaded


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def get_cfg() -> CfgNode:
    """Fresh copy of the default config."""
    from dafne_torch.config.defaults import build_defaults

    return build_defaults()
