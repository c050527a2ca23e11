"""Feature Pyramid Network with P6/P7 (NCHW), counterpart of
``dafne_tpu/models/fpn.py``: lateral 1x1 + output 3x3 convs over res3-res5,
a nearest 2x top-down pathway, and P6 from P5, P7 from relu(P6)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dafne_torch.models.layers import Conv2d


class FPN(nn.Module):
    """top_block: "p6p7", "p6" or "" (none)."""

    def __init__(self, in_channels: Dict[str, int],
                 in_features: Sequence[str] = ("res3", "res4", "res5"),
                 out_channels: int = 256, top_block: str = "p6p7", fuse_type: str = "sum"):
        super().__init__()
        if top_block not in ("p6p7", "p6", ""):
            raise ValueError(f"Unknown FPN top block {top_block!r}")
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"Unknown FPN fuse type {fuse_type!r}")
        self.in_features = tuple(in_features)
        self.top_block = top_block
        self.fuse_type = fuse_type
        for f in self.in_features:
            self.add_module(f"lateral_{f}", Conv2d(in_channels[f], out_channels, 1))
            self.add_module(f"output_p{f[-1]}", Conv2d(out_channels, out_channels, 3, padding=1))
        if top_block:
            self.p6 = Conv2d(out_channels, out_channels, 3, 2, padding=1)
        if top_block == "p6p7":
            self.p7 = Conv2d(out_channels, out_channels, 3, 2, padding=1)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [getattr(self, f"lateral_{f}")(features[f]) for f in self.in_features]
        merged = [None] * len(laterals)
        merged[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            up = F.interpolate(merged[i + 1], scale_factor=2, mode="nearest")
            up = up[:, :, : laterals[i].shape[2], : laterals[i].shape[3]]
            fused = laterals[i] + up
            merged[i] = fused / 2.0 if self.fuse_type == "avg" else fused

        outs = {}
        for f, m in zip(self.in_features, merged):
            outs[f"p{f[-1]}"] = getattr(self, f"output_p{f[-1]}")(m)
        top = int(self.in_features[-1][-1])
        if self.top_block:
            p6 = self.p6(outs[f"p{top}"])
            outs[f"p{top + 1}"] = p6
            if self.top_block == "p6p7":
                outs[f"p{top + 2}"] = self.p7(F.relu(p6))
        return outs
