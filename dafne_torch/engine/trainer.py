"""The train step: forward -> target assignment -> losses -> backward -> update.

Counterpart of ``dafne_tpu/engine/trainer.py``: ``level_sizes_for`` (:58),
``make_location_tables`` (:63), ``compute_losses`` (:73, the in-step
assignment branch), ``resolve_train_device_aug`` (:163),
``device_aug_image`` (:220) and ``make_train_step`` (:317).  The JAX step is a pure
function of (state, batch); here the step updates the model's parameters
and the optimizer in place and returns the metrics: every loss term,
``num_pos`` and ``loss_is_finite`` as tensors on the model's device
(reading them synchronises, so the loop reads them only when it writes)
and the step's ``lr`` as a float.  Assignment runs inside the step, on
the step's device: one launch of the assignment kernel per step on the
card.  With ``device_aug`` (``TPU.TRAIN_DEVICE_AUG``) the step first
renders the augmented canvas on the device from the batch's base images.
The step's one forward runs with ``train=True``, so a model with BN towers
moves its running statistics once per step, as JAX's
``mutable=["batch_stats"]`` apply does.
``TPU.HOST_ASSIGN`` is not ported and raises when set True.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

import torch

from dafne_torch.data.transforms import train_geometric_augs_separable
from dafne_torch.engine.optimizer import clip_gradients_
from dafne_torch.models.head import compute_locations
from dafne_torch.ops.device_warp import WARP_KEYS, device_color_aug, device_warp_batch
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
    [N, K, 8], center [N, K, 2] or None (no center but center-to-corner),
    ctrness [N, K])."""
    center = None if out["center"][0] is None else flatten_levels(out["center"], 2)
    return (flatten_levels(out["logits"], num_classes), flatten_levels(out["corners"], 8),
            center, flatten_levels(out["ctrness"], 1)[..., 0])


def batch_targets(batch, assign_spec: AssignmentSpec, location_tables):
    _, locations, loc_strides, size_ranges = location_tables
    return assign_targets(locations, loc_strides, size_ranges, batch["gt_corners"],
                          batch["gt_hbox"], batch["gt_classes"], batch["gt_area"],
                          batch["gt_valid"], assign_spec)


def compute_losses(model, batch, assign_spec: AssignmentSpec, loss_spec: LossSpec,
                   location_tables, train: bool = False) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(losses, head outputs) of a batch {"image" [N, H, W, 3], gt_* [N, M, ...]}.
    `train` runs the model's forward in train mode: BN towers normalize with
    the batch's statistics and move their running ones, once per call."""
    out = model(batch["image"], train=train)
    logits, corners, center, ctrness = flatten_head(out, loss_spec.num_classes)
    targets = batch_targets(batch, assign_spec, location_tables)
    return dafne_losses(logits, corners, center, ctrness, targets, loss_spec), out


def resolve_train_device_aug(cfg) -> bool:
    """TPU.TRAIN_DEVICE_AUG (False | True | "auto") as a decision.

    True needs every geometric draw to be separable
    (``train_geometric_augs_separable``) and raises ValueError otherwise;
    "auto" is on when the draws are separable and the process may use at
    most 2 host cores (a host that cannot keep the warps ahead of the
    step); any other value raises ValueError."""
    v = cfg.TPU.TRAIN_DEVICE_AUG
    if v is False or v == "False":
        return False
    separable = train_geometric_augs_separable(cfg)
    if v is True or v == "True":
        if not separable:
            raise ValueError(
                "TPU.TRAIN_DEVICE_AUG=True but INPUT.ROTATION_AUG_ANGLES "
                f"{list(cfg.INPUT.ROTATION_AUG_ANGLES)} contains non-90-degree angles: those "
                "draws cannot be rendered on the device; use 'auto' or False")
        return True
    if not (isinstance(v, str) and v.lower() == "auto"):
        raise ValueError(f"TPU.TRAIN_DEVICE_AUG must be bool or 'auto', got {v!r}")
    if not separable:
        return False
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        cores = os.cpu_count() or 1
    enabled = cores <= 2
    logging.getLogger("dafne_torch").info(
        f"TPU.TRAIN_DEVICE_AUG=auto: {cores} usable host core(s) -> "
        f"{'enabled' if enabled else 'disabled'}")
    return enabled


def device_aug_image(batch, color_aug: bool) -> torch.Tensor:
    """The augmented train canvas [B, H, W, 3] float32 rendered on the
    batch's device from a device-aug batch: the separable warp of
    "image_base" by the "aug_*" taps, then with `color_aug` the color
    jitter of "color_light" and "color_w"."""
    img = device_warp_batch(batch["image_base"], {k: batch["aug_" + k] for k in WARP_KEYS})
    if color_aug:
        img = device_color_aug(img, batch["color_light"], batch["color_w"], batch["aug_out_hw"])
    return img


def make_train_step(model, cfg, image_hw: Tuple[int, int], optimizer, scheduler,
                    device_aug: bool = False):
    """The train step of a static canvas: ``step(batch) -> metrics``, the
    batch's tensors on the model's device.  `optimizer` and `scheduler`
    come from ``engine.optimizer.build_optimizer``.  With `device_aug`
    (``resolve_train_device_aug``) the batch carries "image_base" and the
    warp (and color) vectors instead of "image", and the step renders the
    canvas with ``device_aug_image`` before the forward pass, outside
    autograd."""
    if cfg.TPU.HOST_ASSIGN is True:
        raise NotImplementedError("TPU.HOST_ASSIGN=True is not ported")
    device = next(model.parameters()).device
    assign_spec = AssignmentSpec.from_config(cfg)
    loss_spec = LossSpec.from_config(cfg)
    tables = make_location_tables(image_hw, assign_spec, device=device)
    color_aug = bool(cfg.INPUT.USE_COLOR_AUGMENTATIONS)

    def train_step(batch) -> Dict[str, torch.Tensor]:
        lr = scheduler.get_last_lr()[0]  # the "default" group's, as JAX's schedule(step)
        if device_aug:
            batch = {**batch, "image": device_aug_image(batch, color_aug)}
        optimizer.zero_grad(set_to_none=True)
        losses, _ = compute_losses(model, batch, assign_spec, loss_spec, tables, train=True)
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
