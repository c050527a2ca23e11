"""Torch / Detectron2 checkpoint importer.

The port's copy of ``dafne_tpu/utils/weight_import.py``.  It fills the
port's state dict (module names that follow the flax tree,
``utils/weights.py``) from the reference's weights:

- Detectron2 ImageNet backbone pickles (``R-50.pkl``): numpy arrays under
  Detectron2's names (``stem.conv1.weight``, ``res2.0.conv1.norm.*``), or
  the MSRA Caffe2 names (``conv1_w``, ``res_conv1_bn_s``,
  ``res2_0_branch2a_w``), converted by ``convert_c2_names``;
- full DAFNe checkpoints (``model_*.pth``: ``backbone.bottom_up.*``,
  ``backbone.fpn_*``, ``proposal_generator.dafne_head.*``), also with a
  DDP ``module.`` prefix.

A file is read by its content (a ``torch.save`` zip, else a pickle), not
by its extension as the JAX package reads it.

``_map_key`` keeps the JAX package's map from a reference name to a flax
path, and ``_state_key`` turns that path into the port's name (``kernel``
and ``scale`` become ``weight``, the BN towers' ``batch_stats`` leaves
``mean`` and ``var`` become ``running_mean`` and ``running_var``).  Torch
checkpoints are already OIHW, so no conv kernel is transposed.  A tensor
whose shape differs from its target is skipped (or raises with
``strict``); unmatched reference keys and unfilled targets are reported,
so gaps are visible.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import pickle
import re
import zipfile
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

logger = logging.getLogger("dafne_torch")


@dataclasses.dataclass
class ImportReport:
    """Which reference tensors were consumed and which targets filled."""

    used: List[str] = dataclasses.field(default_factory=list)
    unmatched: List[str] = dataclasses.field(default_factory=list)
    filled: Set[str] = dataclasses.field(default_factory=set)
    target_paths: Set[str] = dataclasses.field(default_factory=set)

    @property
    def unfilled(self) -> List[str]:
        return sorted(self.target_paths - self.filled)


_C2_STAGE = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3",
             "branch1": "shortcut"}


def convert_c2_names(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Caffe2-style MSRA ImageNet names (``conv1_w``, ``res_conv1_bn_s``,
    ``res2_0_branch2a_w``) to Detectron2 module names, as Detectron2's
    ``convert_basic_c2_names`` does for the ResNet subset.  The BN is
    stored as scale and bias only (FrozenBN: mean 0 and variance 1 are
    implied, and those targets keep their initial values)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("fc1000") or k.startswith("pred_"):
            continue  # classifier head, not used by detection
        if k == "conv1_w":
            out["stem.conv1.weight"] = v
        elif k in ("res_conv1_bn_s", "conv1_bn_s"):
            out["stem.conv1.norm.weight"] = v
        elif k in ("res_conv1_bn_b", "conv1_bn_b"):
            out["stem.conv1.norm.bias"] = v
        else:
            m = re.match(r"res(\d)_(\d+)_(branch\w+)_(w|bn_s|bn_b)$", k)
            if not m:
                out[k] = v
                continue
            conv = _C2_STAGE.get(m[3])
            if conv is None:
                out[k] = v
                continue
            suffix = {"w": "weight", "bn_s": "norm.weight", "bn_b": "norm.bias"}[m[4]]
            out[f"res{m[1]}.{m[2]}.{conv}.{suffix}"] = v
    return out


def _looks_like_c2(sd: Dict[str, np.ndarray]) -> bool:
    return any(re.match(r"res\d_\d+_branch", k) for k in sd) or "conv1_w" in sd


def read_weights_file(path: str):
    """A weights file as stored, told apart by content.  A ``torch.save``
    file (the port's checkpoints, Detectron2 ``.pth``) loads through
    ``torch.load(weights_only=True)``, which builds tensors and plain
    containers only.  Any other file is read as a pickle (latin1, as
    Detectron2 and the MSRA models write their ``.pkl`` files): its numpy
    arrays need the unrestricted unpickler, which runs whatever code the
    file holds, so load ``.pkl`` files only from a source you trust."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if isinstance(data, int) and data == torch.serialization.MAGIC_NUMBER:
        # the first record of a pre-zip torch.save file
        return torch.load(path, map_location="cpu", weights_only=True)
    return data


def state_arrays(data) -> Dict[str, np.ndarray]:
    """A loaded file's state dict as numpy arrays: its "model" entry when
    there is one, without the ``pixel_*`` buffers."""
    sd = data.get("model", data)
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}
    return {k: np.asarray(v) for k, v in sd.items() if not k.startswith("pixel_")}


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    return state_arrays(read_weights_file(path))


def _strip_prefixes(key: str) -> str:
    for p in ("module.", "backbone.bottom_up.", "bottom_up."):
        if key.startswith(p):
            key = key[len(p):]
    return key


def _tower_strides(sd: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Each head tower's layout stride in the checkpoint: the gcd of its
    conv indices (the 4-D weights), 3 for [conv, norm, relu] * N and 2 for
    the no-norm [conv, relu] * N."""
    conv_idx: Dict[str, set] = {}
    for key, value in sd.items():
        m = re.match(r"proposal_generator\.dafne_head\.(\w+)_tower\.(\d+)\.weight$",
                     _strip_prefixes(key))
        if m and np.asarray(value).ndim == 4:
            conv_idx.setdefault(m[1], set()).add(int(m[2]))
    strides = {}
    for tower, ixs in conv_idx.items():
        nonzero = sorted(i for i in ixs if i)
        strides[tower] = math.gcd(*nonzero) if nonzero else 3
    return strides


def _conv(leaf: str):
    return ("kernel" if leaf == "weight" else "bias"), ("conv_w" if leaf == "weight" else "b")


def _map_key(key: str, tower_strides: Optional[Dict[str, int]] = None
             ) -> Optional[Tuple[Tuple, str]]:
    """Reference key -> (flax path tuple, kind), kind in {conv_w, b, affine,
    scale_elem, ignore}; None when the key maps to nothing."""
    k = _strip_prefixes(key)

    # backbone stem and stages
    m = re.match(r"stem\.conv1\.(weight|bias)$", k)
    if m:
        leaf, kind = _conv(m[1])
        return ("backbone", "stem_conv1", leaf), kind
    m = re.match(r"stem\.conv1\.norm\.(\w+)$", k)
    if m:
        return ("backbone", "stem_conv1_norm", m[1]), "affine"
    m = re.match(r"res(\d)\.(\d+)\.(conv\d|shortcut)\.weight$", k)
    if m:
        return ("backbone", f"res{m[1]}_{m[2]}", m[3], "kernel"), "conv_w"
    m = re.match(r"res(\d)\.(\d+)\.(conv\d|shortcut)\.norm\.(\w+)$", k)
    if m:
        return ("backbone", f"res{m[1]}_{m[2]}", f"{m[3]}_norm", m[4]), "affine"

    # FPN
    m = re.match(r"(?:backbone\.)?fpn_lateral(\d)\.(weight|bias)$", k)
    if m:
        leaf, kind = _conv(m[2])
        return ("fpn", f"lateral_res{m[1]}", leaf), kind
    m = re.match(r"(?:backbone\.)?fpn_output(\d)\.(weight|bias)$", k)
    if m:
        leaf, kind = _conv(m[2])
        return ("fpn", f"output_p{m[1]}", leaf), kind
    m = re.match(r"(?:backbone\.)?top_block\.p(\d)\.(weight|bias)$", k)
    if m:
        leaf, kind = _conv(m[2])
        return ("fpn", f"p{m[1]}", leaf), kind

    # DAFNe head.  BN towers keep one BatchNorm per FPN level
    # (`tower.{3i+1}.{level}.{leaf}`): norm{i}_level{level}, its running
    # statistics flax's batch_stats leaves mean and var.
    m = re.match(r"proposal_generator\.dafne_head\.(cls|corners|center|share)_tower\."
                 r"(\d+)\.(\d+)\.(weight|bias|running_mean|running_var|num_batches_tracked)$", k)
    if m:
        tower, idx, lvl, leaf = m[1], int(m[2]), int(m[3]), m[4]
        if leaf == "num_batches_tracked":
            return ("__ignored__",), "ignore"
        s_ = (tower_strides or {}).get(tower, 3)
        leaf_name = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                     "running_var": "var"}[leaf]
        return ("head", f"{tower}_tower", f"norm{idx // s_}_level{lvl}", leaf_name), "b"
    m = re.match(r"proposal_generator\.dafne_head\.(cls|corners|center|share)_tower\."
                 r"(\d+)\.(weight|bias)$", k)
    if m:
        tower, idx, wb = m[1], int(m[2]), m[3]
        # a torch Sequential: conv at s*i, norm at s*i+1 (s the tower's stride)
        s_ = (tower_strides or {}).get(tower, 3)
        if idx % s_ == 0:
            leaf, kind = _conv(wb)
            return ("head", f"{tower}_tower", f"conv{idx // s_}", leaf), kind
        return ("head", f"{tower}_tower", f"norm{idx // s_}",
                "scale" if wb == "weight" else "bias"), "b"
    m = re.match(r"proposal_generator\.dafne_head\.(cls_logits|ctrness|corners_pred|center_pred"
                 r"|xywha_pred|c\d_pred)\.(weight|bias)$", k)
    if m:
        leaf, kind = _conv(m[2])
        return ("head", m[1], leaf), kind
    m = re.match(r"proposal_generator\.dafne_head\.scales\.(\d+)\.scale$", k)
    if m:
        return ("head", "scales", int(m[1])), "scale_elem"
    m = re.match(r"top_module\.(weight|bias)$", k)
    if m:
        leaf, kind = _conv(m[1])
        return ("top_module", leaf), kind
    return None


def _state_key(path: Tuple) -> str:
    """A flax path -> the port's state-dict name."""
    *module, leaf = path
    names = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
    return ".".join([*module, names.get(leaf, leaf)])


def import_state_dict(sd: Dict[str, np.ndarray], target: Dict[str, torch.Tensor],
                      strict: bool = False) -> Tuple[Dict[str, torch.Tensor], ImportReport]:
    """Fill a copy of `target` (the port's state dict) from a reference
    state dict.  Returns (the filled state dict, report); with `strict` a
    shape mismatch raises."""
    if _looks_like_c2(sd):
        sd = convert_c2_names(sd)
    tower_strides = _tower_strides(sd)
    out = {k: v.detach().clone() for k, v in target.items()}
    report = ImportReport(target_paths=set(out))
    scales_updates: Dict[int, float] = {}
    for key, value in sd.items():
        mapped = _map_key(key, tower_strides)
        if mapped is None:
            report.unmatched.append(key)
            continue
        path, kind = mapped
        if kind == "ignore":
            report.used.append(key)
            continue
        if kind == "scale_elem":
            scales_updates[path[-1]] = float(np.asarray(value).reshape(()))
            report.used.append(key)
            continue
        name = _state_key(path)
        if name not in out:
            report.unmatched.append(key)
            continue
        v = torch.from_numpy(np.array(value, np.float32))
        if tuple(v.shape) != tuple(out[name].shape):
            msg = f"shape mismatch for {key}: {tuple(v.shape)} vs {tuple(out[name].shape)}"
            if strict:
                raise ValueError(msg)
            logger.warning(msg)
            report.unmatched.append(key)
            continue
        out[name] = v.to(out[name].dtype)
        report.used.append(key)
        report.filled.add(name)

    if scales_updates and "head.scales" in out:
        for i, val in scales_updates.items():
            out["head.scales"][i] = val
        report.filled.add("head.scales")

    logger.info(f"weight import: {len(report.used)}/{len(sd)} reference tensors used, "
                f"{len(report.unmatched)} unmatched, {len(report.unfilled)} targets unfilled")
    if report.unmatched[:10]:
        logger.info(f"first unmatched: {report.unmatched[:10]}")
    return out, report


def looks_like_reference(sd: Dict[str, object]) -> bool:
    """Whether a state dict holds the reference's names (Detectron2's or
    MSRA's): ``_map_key`` maps none of the port's own names."""
    return _looks_like_c2(sd) or any(_map_key(k) is not None for k in sd)


def import_into(model, sd: Dict[str, np.ndarray], strict: bool = False) -> ImportReport:
    """Fill `model` in place (on its device) from a reference state dict."""
    new, report = import_state_dict(sd, model.state_dict(), strict=strict)
    model.load_state_dict(new)
    return report


def load_reference_weights(path: str, model, strict: bool = False) -> ImportReport:
    """Fill `model` in place from a reference checkpoint file.  Returns the
    import report."""
    return import_into(model, _load_state_dict(path), strict=strict)
