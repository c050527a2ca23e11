"""Detectron2-structured ResNet trunk (NCHW), counterpart of
``dafne_tpu/models/resnet.py``.

FrozenBN after every conv, a 7x7/2 stem and a 3x3/2 max-pool; bottleneck
blocks from depth 50 up (the stride on the first 1x1 under
``STRIDE_IN_1X1``), basic 3x3 -> 3x3 blocks at depths 18 and 34.  With
``deform_interval`` k > 0 (``build_resnet_interval_backbone``) the 3x3 of
every k-th bottleneck of stages res3-res5 is a ``DeformConv2d``, where that
3x3 has stride 1 (a first block under ``STRIDE_IN_1X1 False`` keeps its
strided regular conv).  Module names follow the JAX parameter tree
(``stem_conv1``, ``res2_0.conv1_norm``, ...), so ``utils/weights.py`` maps
one onto the other by name.  The JAX package's space-to-depth stem is the
same function lowered for the TPU; here the stem is the plain 7x7/2 conv.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dafne_torch.layers import deform_conv
from dafne_torch.models.layers import Conv2d, FrozenBN

# blocks per stage res2..res5
RESNET_STAGES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut when the
    shape changes."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, stride_in_1x1: bool = True, deform: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        if in_channels != out_channels or stride != 1:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride, bias=False)
            self.shortcut_norm = FrozenBN(out_channels)
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, s1, bias=False)
        self.conv1_norm = FrozenBN(bottleneck_channels)
        if deform and s3 == 1:
            self.conv2 = deform_conv.DeformConv2d(bottleneck_channels, bottleneck_channels)
        else:
            self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, s3, padding=1,
                                bias=False)
        self.conv2_norm = FrozenBN(bottleneck_channels)
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False)
        self.conv3_norm = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut_norm(self.shortcut(x))
        y = F.relu(self.conv1_norm(self.conv1(x)))
        y = F.relu(self.conv2_norm(self.conv2(y)))
        y = self.conv3_norm(self.conv3(y))
        return F.relu(y + shortcut)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34), the stride on the first
    3x3, with a projection shortcut when the shape changes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        if in_channels != out_channels or stride != 1:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride, bias=False)
            self.shortcut_norm = FrozenBN(out_channels)
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_channels, out_channels, 3, stride, padding=1, bias=False)
        self.conv1_norm = FrozenBN(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.conv2_norm = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut_norm(self.shortcut(x))
        y = F.relu(self.conv1_norm(self.conv1(x)))
        y = self.conv2_norm(self.conv2(y))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """ResNet-18/34/50/101/152 trunk returning {"res3": ..., "res5": ...}
    (NCHW), restricted to `out_features`."""

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res3", "res4", "res5"),
                 num_groups: int = 1, width_per_group: int = 64, stem_out_channels: int = 64,
                 res2_out_channels: int = 256, stride_in_1x1: bool = True,
                 deform_interval: int = 0):
        super().__init__()
        if depth not in RESNET_STAGES:
            raise ValueError(f"ResNet depth {depth} (one of {sorted(RESNET_STAGES)})")
        self.out_features = tuple(out_features)
        self.stem_conv1 = Conv2d(3, stem_out_channels, 7, 2, padding=3, bias=False)
        self.stem_conv1_norm = FrozenBN(stem_out_channels)

        in_ch = stem_out_channels
        out_ch = res2_out_channels
        bottleneck = num_groups * width_per_group
        max_stage = max(int(f[-1]) for f in self.out_features)
        self.stage_names = []
        for stage in range(2, max_stage + 1):
            for b in range(RESNET_STAGES[depth][stage - 2]):
                stride = 2 if (b == 0 and stage > 2) else 1
                name = f"res{stage}_{b}"
                if depth >= 50:
                    deform = deform_interval > 0 and b % deform_interval == 0 and stage >= 3
                    block = BottleneckBlock(in_ch, out_ch, bottleneck, stride, stride_in_1x1,
                                            deform)
                else:
                    block = BasicBlock(in_ch, out_ch, stride)
                self.add_module(name, block)
                in_ch = out_ch
            self.stage_names.append([f"res{stage}_{b}" for b in range(RESNET_STAGES[depth][stage - 2])])
            out_ch *= 2
            bottleneck *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem_conv1_norm(self.stem_conv1(x)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        outputs = {}
        for stage, names in enumerate(self.stage_names, start=2):
            for name in names:
                y = getattr(self, name)(y)
            if f"res{stage}" in self.out_features:
                outputs[f"res{stage}"] = y
        return outputs
