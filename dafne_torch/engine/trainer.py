"""The train step: forward -> target assignment -> losses -> backward -> update.

Counterpart of ``dafne_tpu/engine/trainer.py``: ``level_sizes_for`` (:58),
``make_location_tables`` (:63), ``compute_losses`` (:73, the in-step
assignment branch) and ``make_train_step`` (:317).  The JAX step is a pure
function of (state, batch); here the step updates the model's parameters
and the optimizer in place and returns the metrics: every loss term,
``num_pos`` and ``loss_is_finite`` as tensors on the model's device
(reading them synchronises, so the loop reads them only when it writes)
and the step's ``lr`` as a float.  Assignment runs inside the step, on
the step's device: one launch of the assignment kernel per step on the
card.
``TPU.HOST_ASSIGN`` and ``TPU.TRAIN_DEVICE_AUG`` are not ported and raise
when set True.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dafne_torch.engine.optimizer import clip_gradients_
from dafne_torch.models.head import compute_locations
from dafne_torch.ops.losses import LossSpec, dafne_losses
from dafne_torch.ops.targets import (
    AssignmentSpec,
    assign_targets,
    flatten_levels,
    level_metadata,
)


def level_sizes_for(image_hw: Tuple[int, int], strides) -> list:
    h, w = image_hw
    return [((h + s - 1) // s, (w + s - 1) // s) for s in strides]


def make_location_tables(image_hw, spec: AssignmentSpec, device=None):
    """(per-level locations, locations [K, 2], strides [K], size_ranges
    [K, 2]) of a static canvas."""
    sizes = level_sizes_for(image_hw, spec.strides)
    locs = [compute_locations(h, w, s, device=device) for (h, w), s in zip(sizes, spec.strides)]
    loc_strides, size_ranges = level_metadata(sizes, spec, device=device)
    return locs, torch.cat(locs, dim=0), loc_strides, size_ranges


def flatten_head(out, num_classes: int):
    """The model's per-level NHWC outputs as (logits [N, K, C], corners
    [N, K, 8], center [N, K, 2], ctrness [N, K])."""
    return (flatten_levels(out["logits"], num_classes), flatten_levels(out["corners"], 8),
            flatten_levels(out["center"], 2), flatten_levels(out["ctrness"], 1)[..., 0])


def batch_targets(batch, assign_spec: AssignmentSpec, location_tables):
    _, locations, loc_strides, size_ranges = location_tables
    return assign_targets(locations, loc_strides, size_ranges, batch["gt_corners"],
                          batch["gt_hbox"], batch["gt_classes"], batch["gt_area"],
                          batch["gt_valid"], assign_spec)


def compute_losses(model, batch, assign_spec: AssignmentSpec, loss_spec: LossSpec,
                   location_tables) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(losses, head outputs) of a batch {"image" [N, H, W, 3], gt_* [N, M, ...]}."""
    out = model(batch["image"])
    logits, corners, center, ctrness = flatten_head(out, loss_spec.num_classes)
    targets = batch_targets(batch, assign_spec, location_tables)
    return dafne_losses(logits, corners, center, ctrness, targets, loss_spec), out


def make_train_step(model, cfg, image_hw: Tuple[int, int], optimizer, scheduler):
    """The train step of a static canvas: ``step(batch) -> metrics``, the
    batch's tensors on the model's device.  `optimizer` and `scheduler`
    come from ``engine.optimizer.build_optimizer``."""
    if cfg.TPU.HOST_ASSIGN is True:
        raise NotImplementedError("TPU.HOST_ASSIGN=True is not ported")
    if cfg.TPU.TRAIN_DEVICE_AUG is True:
        raise NotImplementedError("TPU.TRAIN_DEVICE_AUG=True is not ported")
    device = next(model.parameters()).device
    assign_spec = AssignmentSpec.from_config(cfg)
    loss_spec = LossSpec.from_config(cfg)
    tables = make_location_tables(image_hw, assign_spec, device=device)

    def train_step(batch) -> Dict[str, torch.Tensor]:
        lr = scheduler.get_last_lr()[0]  # the "default" group's, as JAX's schedule(step)
        optimizer.zero_grad(set_to_none=True)
        losses, _ = compute_losses(model, batch, assign_spec, loss_spec, tables)
        loss = losses["loss/total"]
        loss.backward()
        clip_gradients_(optimizer, cfg)
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_is_finite"] = torch.isfinite(metrics["loss/total"])
        metrics["lr"] = lr
        return metrics

    return train_step
