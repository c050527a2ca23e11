"""Dense target assignment, batched over images.

Counterpart of ``dafne_tpu/ops/targets.py``: ``AssignmentSpec`` (:37),
``level_metadata`` (:72), ``assign_targets_single`` (:123),
``_finalize_assignment`` (:235), ``flatten_levels`` (:279) and
``assign_targets`` (:286).  The JAX package vmaps a per-image scan (or the
Pallas kernel) over the batch; here one call of
``ops.kernels.assign.assign_argmin`` covers the whole batch, so a train step
launches the assignment kernel once.  The scan body and
``_center_sample_mask`` (:99) live in ``assign_argmin_plain``, which
restates the kernel.

Semantics (reference ``dafne_outputs.py:252-503``): a location is positive
for a gt when it passes center sampling and the point-in-quad test (both
toggleable) and its max-ltrb lies in its FPN level's size range; among
those gts the smallest area wins, the first index on equal areas; targets
are divided by the FPN stride when ``ENABLE_FPN_STRIDE_NORM``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from dafne_torch.geometry.quads import compute_abcd
from dafne_torch.ops.kernels.assign import (
    INF,
    assign_argmin,
    assign_argmin_cuda,
    assign_argmin_plain,
)


@dataclasses.dataclass(frozen=True)
class AssignmentSpec:
    """Static assignment configuration."""

    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    sizes_of_interest: Tuple[int, ...] = (64, 128, 256, 512)
    num_classes: int = 15
    pos_radius: float = 2.0
    center_sample: bool = True
    center_sample_only: bool = False
    combine_center_sample: bool = True
    enable_in_box_check: bool = True
    enable_level_size_filtering: bool = True
    enable_fpn_stride_norm: bool = True
    impl: str = "auto"  # "pallas" (the CUDA kernel), "xla" (plain), "auto" (by device)

    @classmethod
    def from_config(cls, cfg) -> "AssignmentSpec":
        d = cfg.MODEL.DAFNE
        return cls(
            impl=cfg.TPU.ASSIGN_IMPL,
            strides=tuple(d.FPN_STRIDES),
            sizes_of_interest=tuple(d.SIZES_OF_INTEREST),
            num_classes=d.NUM_CLASSES,
            pos_radius=d.POS_RADIUS,
            center_sample=d.CENTER_SAMPLE,
            center_sample_only=d.CENTER_SAMPLE_ONLY,
            combine_center_sample=d.COMBINE_CENTER_SAMPLE,
            enable_in_box_check=d.ENABLE_IN_BOX_CHECK,
            enable_level_size_filtering=d.ENABLE_LEVEL_SIZE_FILTERING,
            enable_fpn_stride_norm=d.ENABLE_FPN_STRIDE_NORM,
        )


def level_metadata(level_sizes: Sequence[Tuple[int, int]], spec: AssignmentSpec, device=None):
    """(strides [K], size_ranges [K, 2]) f32 for the concatenated levels
    [(H_l, W_l), ...]: level l covers (soi[l-1], soi[l]], with -1 below the
    first and INF above the last (dafne_outputs.py:183-190)."""
    bounds = [-1.0] + [float(s) for s in spec.sizes_of_interest] + [INF]
    strides, ranges = [], []
    for lvl, (h, w) in enumerate(level_sizes):
        k = h * w
        strides.append(torch.full((k,), float(spec.strides[lvl]), dtype=torch.float32,
                                  device=device))
        lo_hi = torch.tensor(bounds[lvl : lvl + 2], dtype=torch.float32, device=device)
        ranges.append(lo_hi[None, :].expand(k, 2))
    return torch.cat(strides), torch.cat(ranges, dim=0)


def _finalize_assignment(locations, loc_strides, gt_corners, gt_hbox, gt_classes,
                         min_area, min_idx, spec: AssignmentSpec) -> Dict[str, torch.Tensor]:
    """Labels and the winning gt's target vectors, [B, K, ...].  Background
    locations gather gt 0 (min_idx is 0 there), as the JAX function does."""
    m = gt_classes.shape[1]
    background = min_area >= INF
    sel = min_idx.long().clamp(0, m - 1)  # [B, K]
    labels = torch.where(background, spec.num_classes, torch.gather(gt_classes, 1, sel))
    gt_inds = torch.where(background, -1, min_idx)
    sel_corners = torch.gather(gt_corners, 1, sel[..., None].expand(-1, -1, 8))
    sel_hbox = torch.gather(gt_hbox, 1, sel[..., None].expand(-1, -1, 4))

    x, y = locations[:, 0], locations[:, 1]
    reg_ltrb = torch.stack(
        [x - sel_hbox[..., 0], y - sel_hbox[..., 1], sel_hbox[..., 2] - x, sel_hbox[..., 3] - y],
        dim=-1,
    )
    reg_abcd = compute_abcd(sel_corners, locations)
    reg_corners = sel_corners - locations.repeat(1, 4)
    if spec.enable_fpn_stride_norm:
        s = loc_strides[:, None]
        reg_ltrb = reg_ltrb / s
        reg_abcd = reg_abcd / s
        reg_corners = reg_corners / s
    return {
        "labels": labels.to(torch.int32),
        "gt_inds": gt_inds.to(torch.int32),
        "reg_corners": reg_corners,
        "reg_ltrb": reg_ltrb,
        "reg_abcd": reg_abcd,
    }


_ARGMIN = {"pallas": assign_argmin_cuda, "xla": assign_argmin_plain, "auto": assign_argmin}


@torch.no_grad()
def assign_targets(locations, loc_strides, size_ranges, gt_corners, gt_hbox, gt_classes,
                   gt_area, gt_valid, spec: AssignmentSpec) -> Dict[str, torch.Tensor]:
    """Assign every location of every image: gt_* carry a leading batch
    axis [B, M, ...]; returns labels [B, K] (num_classes = background),
    gt_inds [B, K] (-1 = background), reg_corners [B, K, 8], reg_ltrb and
    reg_abcd [B, K, 4].  Assignment has no gradient."""
    if spec.impl not in _ARGMIN:
        raise ValueError(f"Unknown assignment impl {spec.impl!r}")
    min_area, min_idx = _ARGMIN[spec.impl](locations, loc_strides, size_ranges, gt_corners,
                                           gt_hbox, gt_area, gt_valid, spec)
    return _finalize_assignment(locations, loc_strides, gt_corners, gt_hbox, gt_classes,
                                min_area, min_idx, spec)


def assign_targets_single(locations, loc_strides, size_ranges, gt_corners, gt_hbox,
                          gt_classes, gt_area, gt_valid, spec: AssignmentSpec):
    """One image: gt_* without the batch axis; returns [K, ...]."""
    out = assign_targets(locations, loc_strides, size_ranges, gt_corners[None], gt_hbox[None],
                         gt_classes[None], gt_area[None], gt_valid[None], spec)
    return {k: v[0] for k, v in out.items()}


def flatten_levels(per_level, channels: int) -> torch.Tensor:
    """[N, H_l, W_l, C] per level -> [N, K, C], level-major
    (dafne_outputs.py:575-606)."""
    return torch.cat([x.reshape(x.shape[0], -1, channels) for x in per_level], dim=1)
