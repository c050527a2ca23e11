"""DAFNe dense prediction head (NCHW), counterpart of
``dafne_tpu/models/head.py`` for the center-to-corner strategy.

Towers of 3x3 conv -> GroupNorm -> ReLU with weights shared across FPN
levels, a learned Scale per level, and the prediction convs cls_logits,
ctrness, corners_pred and center_pred.  The other corner strategies, BN
towers, Mish and deformable towers are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dafne_torch.models.layers import Conv2d, GroupNorm


def compute_locations(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """[h*w, 2] (x, y) pixel-center locations of one level, row-major."""
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], dim=1)


class Tower(nn.Module):
    """num_convs x (3x3 conv -> GroupNorm(C // 8 groups) -> ReLU)."""

    def __init__(self, num_convs: int, channels: int):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(channels, channels, 3, padding=1))
            self.add_module(f"norm{i}", GroupNorm(channels // 8, channels, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)))
        return x


class DAFNeHead(nn.Module):
    """Applies to every level; returns per-level lists of NCHW tensors:
    logits [N, C, H, W], corners [N, 8, H, W], center [N, 2, H, W],
    ctrness [N, 1, H, W]."""

    def __init__(self, num_classes: int, num_levels: int, in_channels: int = 256,
                 num_cls_convs: int = 4, num_box_convs: int = 4, num_share_convs: int = 0,
                 norm: str = "GN", use_scale: bool = True, prior_prob: float = 0.01,
                 corner_prediction: str = "center-to-corner",
                 corner_tower_on_center_tower: bool = True,
                 merge_corner_center_pred: bool = False, centerness: str = "oriented",
                 ctr_on_reg: bool = True, use_deformable: bool = False, use_relu: bool = True):
        super().__init__()
        unported = {
            "corner_prediction": corner_prediction != "center-to-corner",
            "merge_corner_center_pred": merge_corner_center_pred,
            "norm": norm != "GN",
            "use_deformable": use_deformable,
            "use_relu=False (Mish)": not use_relu,
        }
        for what, bad in unported.items():
            if bad:
                raise NotImplementedError(f"DAFNe head option not ported yet: {what}")
        c = in_channels
        self.use_scale = use_scale
        self.has_ctr = centerness != "none"
        self.ctr_on_reg = ctr_on_reg
        self.corner_tower_on_center_tower = corner_tower_on_center_tower
        self.share_tower = Tower(num_share_convs, c)
        self.cls_tower = Tower(num_cls_convs, c)
        self.corners_tower = Tower(num_box_convs, c)
        self.center_tower = Tower(num_box_convs, c)
        self.cls_logits = Conv2d(c, num_classes, 3, padding=1)
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        if self.has_ctr:
            self.ctrness = Conv2d(c, 1, 3, padding=1)
        self.corners_pred = Conv2d(c, 8, 3, padding=1)
        self.center_pred = Conv2d(c, 2, 3, padding=1)
        if use_scale:
            self.scales = nn.Parameter(torch.ones(num_levels))

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        out = {"logits": [], "corners": [], "center": [], "ctrness": []}
        for level, feat in enumerate(features):
            feat = self.share_tower(feat)
            ct = self.cls_tower(feat)
            cent = self.center_tower(feat)
            bt = self.corners_tower(cent if self.corner_tower_on_center_tower else feat)
            reg_center = self.center_pred(cent)
            reg_corners = reg_center.repeat(1, 4, 1, 1) + self.corners_pred(bt)
            if self.use_scale:
                s = self.scales[level].to(reg_corners.dtype)
                reg_corners = reg_corners * s
                reg_center = reg_center * s
            out["logits"].append(self.cls_logits(ct))
            out["corners"].append(reg_corners)
            out["center"].append(reg_center)
            if self.has_ctr:
                out["ctrness"].append(self.ctrness(bt if self.ctr_on_reg else ct))
            else:
                out["ctrness"].append(feat.new_ones((feat.shape[0], 1) + feat.shape[2:]))
        return out
