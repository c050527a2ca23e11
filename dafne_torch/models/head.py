"""DAFNe dense prediction head (NCHW), counterpart of
``dafne_tpu/models/head.py``.

Towers of 3x3 conv -> norm -> activation with conv weights shared across
FPN levels, a learned Scale per level, the prediction convs and all five
corner strategies:

  direct            corners_pred on the corners tower
  iterative         c0_pred..c3_pred, each on the tower output concatenated
                    with the corners before it
  center-to-corner  center_pred + corners_pred (the default; with
                    MERGE_CORNER_CENTER_PRED both on the corners tower and
                    no center tower)
  offset            the fixed base square [-2, 2, 2, 2, 2, -2, -2, -2] +
                    corners_pred
  angle             xywha_pred -> the box (x, y, w, h) rotated by
                    alpha = sigmoid * pi - pi / 2 about its corners' mean

Deformable towers (MODEL.DAFNE.USE_DEFORMABLE) are not ported and raise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dafne_torch.models.layers import BatchNorm, Conv2d, GroupNorm, mish

CORNER_PREDICTIONS = ("direct", "iterative", "center-to-corner", "offset", "angle")
OFFSET_BASE = (-2.0, 2.0, 2.0, 2.0, 2.0, -2.0, -2.0, -2.0)


def compute_locations(h: int, w: int, stride: int, device=None) -> torch.Tensor:
    """[h*w, 2] (x, y) pixel-center locations of one level, row-major."""
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], dim=1)


class Tower(nn.Module):
    """num_convs x (3x3 conv -> norm -> ReLU or Mish), as JAX's ``Tower``.

    `norm` is "GN" (GroupNorm of C // 8 groups, ``norm{i}``), "BN" or
    "SyncBN" (one ``BatchNorm`` per FPN level, ``norm{i}_level{l}``: the
    convs are shared across levels, the norms are not), or "" / "none".
    BN and SyncBN both normalize over the global batch, as JAX's one SPMD
    program does: with several processes ``BatchNorm`` sums its statistics
    over them.  ``forward(x, level, train)``: `train` moves the BN running
    statistics.  The deformable last conv (USE_DEFORMABLE) is not ported:
    ``DAFNeHead`` raises for it."""

    def __init__(self, num_convs: int, channels: int, norm: str = "GN", num_levels: int = 5,
                 use_relu: bool = True):
        super().__init__()
        if norm not in ("GN", "BN", "SyncBN", "", "none", None):
            raise ValueError(f"Unsupported head norm: {norm}")
        self.num_convs = num_convs
        self.per_level = norm in ("BN", "SyncBN")
        self.has_norm = norm not in ("", "none", None)
        self.act = F.relu if use_relu else mish
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(channels, channels, 3, padding=1))
            if norm == "GN":
                self.add_module(f"norm{i}", GroupNorm(channels // 8, channels, eps=1e-5))
            elif self.per_level:
                for level in range(num_levels):
                    self.add_module(f"norm{i}_level{level}", BatchNorm(channels))

    def forward(self, x: torch.Tensor, level: int = 0, train: bool = False) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
            if self.per_level:
                x = getattr(self, f"norm{i}_level{level}")(x, train)
            elif self.has_norm:
                x = getattr(self, f"norm{i}")(x)
            x = self.act(x)
        return x


class DAFNeHead(nn.Module):
    """Applies to every level; returns per-level lists of NCHW tensors:
    logits [N, C, H, W], corners [N, 8, H, W], center [N, 2, H, W] (None
    unless center-to-corner), ctrness [N, 1, H, W] (ones under CENTERNESS
    "none").  The submodules exist exactly where JAX declares them."""

    def __init__(self, num_classes: int, num_levels: int, in_channels: int = 256,
                 num_cls_convs: int = 4, num_box_convs: int = 4, num_share_convs: int = 0,
                 norm: str = "GN", use_scale: bool = True, prior_prob: float = 0.01,
                 corner_prediction: str = "center-to-corner",
                 corner_tower_on_center_tower: bool = True,
                 merge_corner_center_pred: bool = False, centerness: str = "oriented",
                 ctr_on_reg: bool = True, use_deformable: bool = False, use_relu: bool = True):
        super().__init__()
        if corner_prediction not in CORNER_PREDICTIONS:
            raise ValueError(f"Unknown MODEL.DAFNE.CORNER_PREDICTION {corner_prediction!r}")
        if use_deformable:
            raise NotImplementedError("MODEL.DAFNE.USE_DEFORMABLE (deformable head towers) is "
                                      "not ported yet")
        c = in_channels
        self.corner_prediction = corner_prediction
        self.merge = merge_corner_center_pred
        self.use_scale = use_scale
        self.has_ctr = centerness != "none"
        self.ctr_on_reg = ctr_on_reg
        self.corner_tower_on_center_tower = corner_tower_on_center_tower

        def tower(n):
            return Tower(n, c, norm, num_levels, use_relu)

        self.share_tower = tower(num_share_convs)
        self.cls_tower = tower(num_cls_convs)
        self.corners_tower = tower(num_box_convs)
        if corner_prediction == "center-to-corner" and not merge_corner_center_pred:
            self.center_tower = tower(num_box_convs)
        self.cls_logits = Conv2d(c, num_classes, 3, padding=1)
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)
        if self.has_ctr:
            self.ctrness = Conv2d(c, 1, 3, padding=1)
        if corner_prediction in ("direct", "center-to-corner", "offset"):
            self.corners_pred = Conv2d(c, 8, 3, padding=1)
        if corner_prediction == "center-to-corner":
            self.center_pred = Conv2d(c, 2, 3, padding=1)
        if corner_prediction == "angle":
            self.xywha_pred = Conv2d(c, 5, 3, padding=1)
        if corner_prediction == "iterative":
            for i in range(4):
                self.add_module(f"c{i}_pred", Conv2d(c + 2 * i, 2, 3, padding=1))
        if use_scale:
            self.scales = nn.Parameter(torch.ones(num_levels))

    def _corners(self, feat: torch.Tensor, level: int, train: bool):
        """(box tower output, corners [N, 8, H, W], center or None)."""
        kind = self.corner_prediction
        if kind == "center-to-corner":
            if self.merge:
                bt = self.corners_tower(feat, level, train)
                center = self.center_pred(bt)
            else:
                cent = self.center_tower(feat, level, train)
                bt = self.corners_tower(cent if self.corner_tower_on_center_tower else feat,
                                        level, train)
                center = self.center_pred(cent)
            return bt, center.repeat(1, 4, 1, 1) + self.corners_pred(bt), center
        bt = self.corners_tower(feat, level, train)
        if kind == "direct":
            return bt, self.corners_pred(bt), None
        if kind == "iterative":
            cs, inp = [], bt
            for i in range(4):
                cs.append(getattr(self, f"c{i}_pred")(inp))
                inp = torch.cat([inp, cs[-1]], dim=1)
            return bt, torch.cat(cs, dim=1), None
        if kind == "offset":
            base = torch.tensor(OFFSET_BASE, dtype=bt.dtype, device=bt.device)
            return bt, base[:, None, None] + self.corners_pred(bt), None
        # angle: corners (x, y), (x, y + h), (x + w, y + h), (x + w, y) turned by
        # the row-vector rotation c' = (c - mean) @ [[cos, sin], [-sin, cos]] + mean
        x0, y0, w, h, alpha = self.xywha_pred(bt).unbind(1)
        xs = torch.stack([x0, x0, x0 + w, x0 + w], dim=1)
        ys = torch.stack([y0, y0 + h, y0 + h, y0], dim=1)
        alpha = torch.sigmoid(alpha) * math.pi - math.pi / 2
        sin, cos = torch.sin(alpha)[:, None], torch.cos(alpha)[:, None]
        mx, my = xs.mean(1, keepdim=True), ys.mean(1, keepdim=True)
        dx, dy = xs - mx, ys - my
        rx = dx * cos + dy * -sin + mx
        ry = dx * sin + dy * cos + my
        return bt, torch.stack([rx, ry], dim=2).flatten(1, 2), None

    def forward(self, features: Sequence[torch.Tensor],
                train: bool = False) -> Dict[str, List[Optional[torch.Tensor]]]:
        out = {"logits": [], "corners": [], "center": [], "ctrness": []}
        for level, feat in enumerate(features):
            feat = self.share_tower(feat, level, train)
            ct = self.cls_tower(feat, level, train)
            bt, reg_corners, reg_center = self._corners(feat, level, train)
            if self.use_scale:
                s = self.scales[level].to(reg_corners.dtype)
                reg_corners = reg_corners * s
                if reg_center is not None:
                    reg_center = reg_center * s
            out["logits"].append(self.cls_logits(ct))
            out["corners"].append(reg_corners)
            out["center"].append(reg_center)
            if self.has_ctr:
                out["ctrness"].append(self.ctrness(bt if self.ctr_on_reg else ct))
            else:
                out["ctrness"].append(feat.new_ones((feat.shape[0], 1) + feat.shape[2:]))
        return out
