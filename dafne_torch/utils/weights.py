"""Convert the JAX package's parameter tree into the port's state dict.

The port's module names follow the flax tree, so the mapping is by name:
conv ``kernel`` [kh, kw, in, out] (HWIO) becomes ``weight`` [out, in, kh, kw]
(OIHW) (a depthwise [3, 3, 1, C] becomes [C, 1, 3, 3], a deformable conv's
1x1 over 9C stacked taps [1, 1, 9C, F] becomes [F, 9C, 1, 1]), a Dense
``kernel`` [in, out] becomes a Linear ``weight`` [out, in], a norm's ``scale`` (GroupNorm, the head's BatchNorm) becomes
``weight``, and the FrozenBN leaves and ``head/scales`` keep their names.
The BN towers' running statistics live in flax's ``batch_stats``
collection (``mean``, ``var``); they become ``running_mean`` and
``running_var`` of the same module.  The input is the flax tree as nested
dicts of numpy arrays (``flax.core.unfreeze`` + ``np.asarray`` on the caller's
side); nothing here imports JAX.  ``params_to_flax`` is the inverse: a
port model's state back into the two flax collections, for the JAX package
to evaluate weights the port trained.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, path + ".")
        else:
            yield path, v


def params_from_flax(params: Dict[str, Any],
                     batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """Flax param tree {"backbone": {...}, "fpn": {...}, "head": {...}} (and
    a model with BN towers: its ``batch_stats``) -> the port's state dict,
    to load with ``strict=True``."""
    out = {}
    for path, value in _flatten(batch_stats or {}):
        module, _, leaf = path.rpartition(".")
        if leaf not in ("mean", "var"):
            raise ValueError(f"{path}: expected a BatchNorm mean or var in batch_stats")
        out[f"{module}.running_{leaf}"] = torch.from_numpy(np.array(value, dtype=np.float32))
    for path, value in _flatten(params):
        a = np.asarray(value, dtype=np.float32)
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            if a.ndim not in (2, 4):
                raise ValueError(f"{path}: expected an HWIO conv or a Dense kernel, got shape "
                                 f"{a.shape}")
            order = (3, 2, 0, 1) if a.ndim == 4 else (1, 0)
            out[f"{module}.weight"] = torch.from_numpy(a.transpose(order).copy())
        elif leaf == "scale":
            out[f"{module}.weight"] = torch.from_numpy(a.copy())
        else:
            out[path] = torch.from_numpy(a.copy())
    return out


def params_to_flax(model: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """`model`'s state -> (flax params, batch_stats) as nested dicts of
    numpy float32 arrays: ``params_from_flax``'s inverse, so that
    ``params_from_flax(*params_to_flax(model))`` is `model`'s state dict.
    A conv or Linear ``weight`` becomes ``kernel`` (HWIO, [in, out]), a
    GroupNorm's or a BN tower's ``weight`` its ``scale``, a BN tower's
    running statistics its ``batch_stats`` ``mean`` and ``var``; every other
    leaf (the FrozenBN leaves, biases, ``head.scales``) keeps its name."""
    from dafne_torch.models.layers import BatchNorm

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, value):
        *parents, leaf = path.split(".")
        for p in parents:
            tree = tree.setdefault(p, {})
        tree[leaf] = value

    for key, value in model.state_dict().items():
        module_name, _, leaf = key.rpartition(".")
        module = model.get_submodule(module_name)
        a = value.detach().cpu().float().numpy()
        if isinstance(module, BatchNorm) and leaf in ("running_mean", "running_var"):
            put(stats, f"{module_name}.{leaf[len('running_'):]}", a)
        elif leaf == "weight" and a.ndim in (2, 4):
            order = (2, 3, 1, 0) if a.ndim == 4 else (1, 0)
            put(params, f"{module_name}.kernel", a.transpose(order).copy())
        elif leaf == "weight" and isinstance(module, (nn.GroupNorm, BatchNorm)):
            put(params, f"{module_name}.scale", a)
        else:
            put(params, key, a)
    return params, stats
