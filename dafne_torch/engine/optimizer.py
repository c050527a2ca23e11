"""Optimizer, parameter groups and LR schedule.

Counterpart of ``dafne_tpu/engine/optimizer.py``: the Detectron2
WarmupMultiStepLR (``warmup_multistep_schedule`` :31) as a ``LambdaLR``
factor; the labels of ``_param_labels`` / ``_freeze_labels`` (:57/:80) as
the optimizer's param groups "default", "bias" and "norm",
with frozen parameters set to ``requires_grad=False``; ``build_optimizer``
(:97) with ``SOLVER.CLIP_GRADIENTS``; and ``auto_scale_config`` (:140).

Labels are computed on each parameter's flax path (a conv's or Linear's
``weight`` is the flax ``kernel``, a GroupNorm's or BatchNorm's ``weight``
its ``scale``, a FrozenBN's ``weight`` keeps its name), with the JAX rules
in their order: backbone leaves under a module whose name holds "norm",
and running stats, are frozen, then any ``bias`` is "bias" (the head
norms' too), then norm-module leaves and ``scale`` are "norm" (GroupNorm's
and the per-level BatchNorms'), the rest "default" (``head.scales`` too);
at ``FREEZE_AT`` f every path holding "backbone/stem" and the stages
res2..res<f> are frozen.  JAX's quirks stay: a DLA, VoVNet or MobileNetV2
FrozenBN is named ``*_bn``, so its ``weight`` is "default" and its ``bias``
"bias" and both train (its running stats are buffers here, frozen there);
and "backbone/stem" freezes VoVNet's ``stem1``-``stem3`` and MobileNetV2's
``stem`` with their BNs.

The update equals the optax chain per group: clip (per group, like optax's
clip inside each ``multi_transform`` group), coupled weight decay, momentum
trace starting at zero, then ``-lr(step)``.  ``torch.optim.SGD`` with
``dampening=0`` adds the decay to the gradient before the momentum, and
``LambdaLR`` gives step 0 the schedule's value at 0, so only the clip
happens outside it: ``clip_gradients_`` runs after ``backward`` and before
``step``.  SOLVER.OPTIMIZER "adam" is JAX's chain clip ->
``add_decayed_weights`` (L2 added to the gradient, not AdamW's decoupled
decay) -> ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
bias-corrected) -> ``-lr(step)``: ``torch.optim.Adam`` with the group's
``weight_decay`` is that chain.  JAX takes any other name as SGD with
momentum; the port raises for a name that is neither "sgd" nor "adam".
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
from torch import nn

from dafne_torch.models.layers import FrozenBN


def _warmup_multistep_factor(count: int, steps, gamma: float, warmup_factor: float,
                             warmup_iters: int, warmup_method: str = "linear") -> float:
    if warmup_method == "constant":
        warm = warmup_factor if count < warmup_iters else 1.0
    else:  # linear
        alpha = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
        warm = warmup_factor * (1 - alpha) + alpha if count < warmup_iters else 1.0
    return warm * gamma ** sum(count >= m for m in steps)


def warmup_multistep_schedule(base_lr: float, steps, gamma: float, warmup_factor: float,
                              warmup_iters: int, warmup_method: str = "linear"
                              ) -> Callable[[int], float]:
    """Detectron2 WarmupMultiStepLR as a function of the step count."""
    return lambda count: base_lr * _warmup_multistep_factor(
        count, sorted(steps), gamma, warmup_factor, warmup_iters, warmup_method)


def flax_path(name: str, param: torch.Tensor, frozen_bn: bool = False) -> str:
    """The flax tree path ("a/b/leaf") of a port parameter name; `frozen_bn`
    when the parameter is a FrozenBN's."""
    module, _, leaf = name.rpartition(".")
    if leaf == "weight" and not frozen_bn:
        leaf = "kernel" if param.ndim in (2, 4) else "scale"
    return "/".join(module.split(".") + [leaf]) if module else leaf


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> its flax path, for every parameter of `model`."""
    frozen_bn = {n for n, m in model.named_modules() if isinstance(m, FrozenBN)}
    return {name: flax_path(name, p, name.rpartition(".")[0] in frozen_bn)
            for name, p in model.named_parameters()}


def _param_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> "frozen" / "bias" / "norm" / "default"."""
    labels = {}
    for name, path in flax_paths(model).items():
        names = path.split("/")
        in_backbone = "backbone" in "/".join(names)
        is_norm_mod = any("norm" in n for n in names[:-1])
        leaf = names[-1]
        if (in_backbone and is_norm_mod) or leaf in ("running_mean", "running_var"):
            labels[name] = "frozen"
        elif leaf == "bias":
            labels[name] = "bias"
        elif is_norm_mod or leaf == "scale":
            labels[name] = "norm"
        else:
            labels[name] = "default"
    return labels


def _freeze_labels(labels: Dict[str, str], model: nn.Module, freeze_at: int) -> Dict[str, str]:
    """Relabel the backbone stages <= freeze_at "frozen"."""
    prefixes = ["backbone/stem"] if freeze_at >= 1 else []
    prefixes += [f"backbone/res{s}_" for s in range(2, freeze_at + 1)]
    paths = flax_paths(model)
    return {
        name: "frozen" if any(pre in paths[name] for pre in prefixes) else lab
        for name, lab in labels.items()
    }


def param_labels(cfg, model: nn.Module) -> Dict[str, str]:
    return _freeze_labels(_param_labels(model), model, cfg.MODEL.BACKBONE.FREEZE_AT)


def build_optimizer(cfg, model: nn.Module):
    """(optimizer, scheduler) over `model`'s parameters.  Frozen parameters
    get ``requires_grad=False`` and join no group.  Call
    ``clip_gradients_(optimizer, cfg)`` between backward and step; step the
    scheduler after each optimizer step."""
    s = cfg.SOLVER
    kind = s.OPTIMIZER.lower()
    if kind not in ("sgd", "adam"):
        raise NotImplementedError(f"SOLVER.OPTIMIZER {s.OPTIMIZER!r} is not ported (sgd and "
                                  "adam are)")
    labels = param_labels(cfg, model)
    hyper = {
        "default": (s.BASE_LR, s.WEIGHT_DECAY),
        "bias": (s.BASE_LR * s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS),
        "norm": (s.BASE_LR, s.WEIGHT_DECAY_NORM),
    }
    groups = {g: [] for g in hyper}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    param_groups = [
        {"params": ps, "name": g, "lr": hyper[g][0], "weight_decay": hyper[g][1]}
        for g, ps in groups.items() if ps
    ]
    if kind == "adam":
        optimizer = torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8)
    else:
        optimizer = torch.optim.SGD(param_groups, momentum=s.MOMENTUM, dampening=0.0,
                                    nesterov=s.NESTEROV)
    # the schedule at base 1.0 is the factor of each group's own base LR
    factor = warmup_multistep_schedule(1.0, s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS,
                                       s.WARMUP_METHOD)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


@torch.no_grad()
def clip_gradients_(optimizer: torch.optim.Optimizer, cfg) -> None:
    """SOLVER.CLIP_GRADIENTS in place, per param group: "value" clamps each
    element to +-CLIP_VALUE; otherwise the group's gradients scale by
    CLIP_VALUE / global norm when that norm is not below CLIP_VALUE
    (optax.clip_by_global_norm's rule, ``(g / norm) * max``)."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return
    for group in optimizer.param_groups:
        grads = [p.grad for p in group["params"] if p.grad is not None]
        if not grads:
            continue
        if c.CLIP_TYPE == "value":
            for g in grads:
                g.clamp_(-c.CLIP_VALUE, c.CLIP_VALUE)
            continue
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < c.CLIP_VALUE
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * c.CLIP_VALUE))


def auto_scale_config(cfg, world_size: int):
    """Batch, LR and schedule scaled from SOLVER.REFERENCE_WORLD_SIZE to
    `world_size` (Detectron2's auto_scale_workers); a new config."""
    old = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old in (0, world_size):
        return cfg
    cfg = copy.deepcopy(cfg)
    scale = world_size / old
    s = cfg.SOLVER
    s.IMS_PER_BATCH = max(world_size, int(round(s.IMS_PER_BATCH * scale)))
    s.BASE_LR = s.BASE_LR * scale
    s.MAX_ITER = int(round(s.MAX_ITER / scale))
    s.WARMUP_ITERS = int(round(s.WARMUP_ITERS / scale))
    s.STEPS = [int(round(x / scale)) for x in s.STEPS]
    test = cfg.get("TEST")
    if test is not None and test.get("EVAL_PERIOD"):
        test.EVAL_PERIOD = int(round(test.EVAL_PERIOD / scale))
    if s.CHECKPOINT_PERIOD:
        s.CHECKPOINT_PERIOD = int(round(s.CHECKPOINT_PERIOD / scale))
    s.REFERENCE_WORLD_SIZE = world_size
    return cfg
