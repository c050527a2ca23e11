"""The other backbone trunks (NCHW), counterparts of
``dafne_tpu/models/backbones.py``: ResNet-LPF, DLA, VoVNet V2 and
MobileNetV2.  Every trunk maps images to {"res3": stride 8, "res4": 16,
"res5": 32} so the same FPN and head compose over any of them;
``feature_channels`` gives each output's width, which the port's FPN takes
up front (JAX infers it).

Module names follow the JAX parameter tree, so ``utils/weights.py`` maps
one onto the other by name.  The ResNet-LPF norms are ``*_norm`` FrozenBNs
(buffers, frozen, as the ResNet trunk's); DLA, VoVNet and MobileNetV2 name
theirs ``*_bn``, which JAX's optimizer labels train (``FrozenBN`` with
``affine_params``).  As in JAX, DLA, VoVNet and MobileNetV2 read no
``FREEZE_AT`` in the forward (their stems are frozen by name alone).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dafne_torch.models.layers import Conv2d, FrozenBN
from dafne_torch.models.resnet import RESNET_STAGES


def conv(in_ch: int, out_ch: int, k: int, s: int = 1, groups: int = 1) -> Conv2d:
    """JAX's ``conv``: k x k, stride s, padding k // 2, no bias."""
    return Conv2d(in_ch, out_ch, k, s, padding=k // 2, groups=groups, bias=False)


def bn(ch: int) -> FrozenBN:
    """A ``*_bn`` FrozenBN, whose affine JAX trains."""
    return FrozenBN(ch, affine_params=True)


def blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """The binomial [1, 2, 1]^T [1, 2, 1] / 16 depthwise blur, subsampled by
    `stride`, after a REFLECT pad of (1, 1) (never zeros), in x's dtype."""
    c = x.shape[1]
    f1 = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64)
    f2 = torch.outer(f1, f1)
    kernel = (f2 / f2.sum()).to(x.dtype).to(x.device)[None, None].expand(c, 1, 3, 3)
    x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, kernel, stride=stride, groups=c)


# ---------------------------------------------------------------------------
# ResNet-LPF (anti-aliased ResNet)
# ---------------------------------------------------------------------------


class LPFBottleneck(nn.Module):
    """A bottleneck whose stride is a blur-pool: 1x1 -> 3x3 (stride 1) ->
    blur-pool -> 1x1; the shortcut blur-pools before its 1x1."""

    def __init__(self, in_ch: int, out_ch: int, bottleneck: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        if in_ch != out_ch or stride != 1:
            self.shortcut = conv(in_ch, out_ch, 1)
            self.shortcut_norm = FrozenBN(out_ch)
        else:
            self.shortcut = None
        self.conv1 = conv(in_ch, bottleneck, 1)
        self.conv1_norm = FrozenBN(bottleneck)
        self.conv2 = conv(bottleneck, bottleneck, 3)
        self.conv2_norm = FrozenBN(bottleneck)
        self.conv3 = conv(bottleneck, out_ch, 1)
        self.conv3_norm = FrozenBN(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut is not None:
            s = blur_pool(x, self.stride) if self.stride != 1 else x
            shortcut = self.shortcut_norm(self.shortcut(s))
        y = F.relu(self.conv1_norm(self.conv1(x)))
        y = F.relu(self.conv2_norm(self.conv2(y)))
        if self.stride != 1:
            y = blur_pool(y, self.stride)
        y = self.conv3_norm(self.conv3(y))
        return F.relu(y + shortcut)


class ResNetLPF(nn.Module):
    """Anti-aliased ResNet trunk at the fixed widths of JAX's (stem 64,
    res2 256): a 7x7/2 stem, a 2x2 stride-1 VALID max-pool and a blur-pool
    (the pool_only stem), then LPF bottlenecks.  The gradient stops after
    the stem (``freeze_at`` >= 1) and after each stage <= ``freeze_at``."""

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res3", "res4", "res5"),
                 freeze_at: int = 2):
        super().__init__()
        self.out_features = tuple(out_features)
        self.freeze_at = freeze_at
        self.stem_conv1 = conv(3, 64, 7, 2)
        self.stem_conv1_norm = FrozenBN(64)
        self.stage_names: List[List[str]] = []
        in_ch, out_ch, bott = 64, 256, 64
        for stage in range(2, 6):
            names = []
            for b in range(RESNET_STAGES[depth][stage - 2]):
                stride = 2 if (b == 0 and stage > 2) else 1
                names.append(f"res{stage}_{b}")
                self.add_module(names[-1], LPFBottleneck(in_ch, out_ch, bott, stride))
                in_ch = out_ch
            self.stage_names.append(names)
            out_ch *= 2
            bott *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem_conv1_norm(self.stem_conv1(x)))
        y = blur_pool(F.max_pool2d(y, 2, 1), 2)
        if self.freeze_at >= 1:
            y = y.detach()
        outs = {}
        for stage, names in enumerate(self.stage_names, start=2):
            for name in names:
                y = getattr(self, name)(y)
            if self.freeze_at >= stage:
                y = y.detach()
            if f"res{stage}" in self.out_features:
                outs[f"res{stage}"] = y
        return outs


# ---------------------------------------------------------------------------
# DLA (Deep Layer Aggregation)
# ---------------------------------------------------------------------------


class DLABasic(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_ch, channels, 3, stride)
        self.bn1 = bn(channels)
        self.conv2 = conv(channels, channels, 3)
        self.bn2 = bn(channels)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class DLABottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (expansion 2), or with `cardinality` > 0 the
    ResNeXt form: width channels * cardinality // 32, grouped 3x3."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1, cardinality: int = 0):
        super().__init__()
        if cardinality:
            bottle, groups = channels * cardinality // 32, cardinality
        else:
            bottle, groups = channels // 2, 1
        self.conv1 = conv(in_ch, bottle, 1)
        self.bn1 = bn(bottle)
        self.conv2 = conv(bottle, bottle, 3, stride, groups=groups)
        self.bn2 = bn(bottle)
        self.conv3 = conv(bottle, channels, 1)
        self.bn3 = bn(channels)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + residual)


def _dla_block(block: str, in_ch: int, channels: int, stride: int, cardinality: int):
    if block == "basic":
        return DLABasic(in_ch, channels, stride)
    if block == "bottleneck":
        return DLABottleneck(in_ch, channels, stride, 0)
    if block == "bottleneckx":
        return DLABottleneck(in_ch, channels, stride, cardinality)
    raise ValueError(block)


class DLARoot(nn.Module):
    """1x1 conv over the concatenated children, BN, the first child added
    when `shortcut`, ReLU."""

    def __init__(self, in_ch: int, channels: int, shortcut: bool):
        super().__init__()
        self.shortcut = shortcut
        self.conv = conv(in_ch, channels, 1)
        self.bn = bn(channels)

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.shortcut:
            x = x + children[0]
        return F.relu(x)


class DLATree(nn.Module):
    """JAX's ``DLATree``.  ``forward(x, children)``: `bottom` is x max-pooled
    by the stride; with ``level_root`` it joins the children.  One level:
    tree1 (strided, on the projected residual) and tree2, then the root over
    [tree2, tree1] + children.  More levels: tree1 is a subtree on x, tree2
    a subtree on tree1's output with children + [tree1's output].  As in
    JAX, ``project`` exists wherever the input width differs from
    `channels`, and is used only by a one-level tree."""

    def __init__(self, levels: int, in_ch: int, channels: int, stride: int = 1,
                 level_root: bool = False, root_shortcut: bool = False, block: str = "basic",
                 cardinality: int = 32, children_ch: int = 0):
        super().__init__()
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if in_ch != channels:
            self.project = conv(in_ch, channels, 1)
            self.project_bn = bn(channels)
        else:
            self.project = None
        if level_root:
            children_ch += in_ch
        if levels == 1:
            self.tree1 = _dla_block(block, in_ch, channels, stride, cardinality)
            self.tree2 = _dla_block(block, channels, channels, 1, cardinality)
            self.root = DLARoot(2 * channels + children_ch, channels, root_shortcut)
        else:
            self.tree1 = DLATree(levels - 1, in_ch, channels, stride,
                                 root_shortcut=root_shortcut, block=block,
                                 cardinality=cardinality)
            self.tree2 = DLATree(levels - 1, channels, channels, 1,
                                 root_shortcut=root_shortcut, block=block,
                                 cardinality=cardinality, children_ch=children_ch + channels)

    def forward(self, x: torch.Tensor, children=()) -> torch.Tensor:
        children = list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            residual = bottom
            if self.project is not None:
                residual = self.project_bn(self.project(bottom))
            t1 = self.tree1(x, residual)
            t2 = self.tree2(t1)
            return self.root([t2, t1] + children)
        t1 = self.tree1(x)
        return self.tree2(t1, tuple(children + [t1]))


# levels, channels, block, root residual, cardinality per variant
DLA_SPECS = {
    "DLA34": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), "basic", False, 32),
    "DLA46_C": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneck", False, 32),
    "DLA46X_C": ((1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), "bottleneckx", False, 32),
    "DLA60X_C": ((1, 1, 1, 2, 3, 1), (16, 32, 64, 64, 128, 256), "bottleneckx", False, 32),
    "DLA60": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneck", False, 32),
    "DLA60X": ((1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx", False, 32),
    "DLA102": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneck", True, 32),
    "DLA102X": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx", True, 32),
    "DLA102X2": ((1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024), "bottleneckx", True, 64),
    "DLA169": ((1, 1, 2, 3, 5, 1), (16, 32, 128, 256, 512, 1024), "bottleneck", True, 32),
}


class DLA(nn.Module):
    """The DLA family; `body` (MODEL.DLA.CONV_BODY) picks the variant.
    res3/4/5 are levels 3-5 (strides 8, 16, 32)."""

    def __init__(self, body: str = "DLA34"):
        super().__init__()
        levels, ch, block, root_res, card = DLA_SPECS[body.upper()]
        self.base_conv = conv(3, ch[0], 7)
        self.base_bn = bn(ch[0])
        self.level0_conv = conv(ch[0], ch[0], 3)
        self.level0_bn = bn(ch[0])
        self.level1_conv = conv(ch[0], ch[1], 3, 2)
        self.level1_bn = bn(ch[1])
        for i in range(2, 6):
            self.add_module(f"level{i}", DLATree(levels[i], ch[i - 1], ch[i], 2, i > 2,
                                                 root_shortcut=root_res, block=block,
                                                 cardinality=card))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.base_bn(self.base_conv(x)))
        y = F.relu(self.level0_bn(self.level0_conv(y)))
        y = F.relu(self.level1_bn(self.level1_conv(y)))
        y = self.level2(y)
        outs = {}
        for i in range(3, 6):
            y = getattr(self, f"level{i}")(y)
            outs[f"res{i}"] = y
        return outs


# ---------------------------------------------------------------------------
# VoVNet V2 (+eSE)
# ---------------------------------------------------------------------------

VOVNET_SPECS = {
    # name: (stem, stage conv channels, stage out channels, convs per block, blocks per stage)
    "V-19-eSE": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 3, (1, 1, 1, 1)),
    "V-39-eSE": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 1, 2, 2)),
    "V-57-eSE": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 1, 4, 3)),
    "V-99-eSE": ((64, 64, 128), (128, 160, 192, 224), (256, 512, 768, 1024), 5, (1, 3, 9, 3)),
}


class ESE(nn.Module):
    """Effective squeeze-excite: x * hard_sigmoid(fc(mean over H, W)),
    ``fc`` flax's Dense (with bias) in the compute dtype; hard_sigmoid
    written as JAX's relu6(s + 3) / 6, the function of ``F.hardsigmoid``."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3))
        s = F.linear(s, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))
        return x * (F.relu6(s + 3.0) / 6.0)[:, :, None, None]


class OSABlock(nn.Module):
    def __init__(self, in_ch: int, conv_ch: int, out_ch: int, num_convs: int,
                 identity: bool = False):
        super().__init__()
        self.num_convs = num_convs
        self.identity = identity
        c = in_ch
        for i in range(num_convs):
            self.add_module(f"conv{i}", conv(c, conv_ch, 3))
            self.add_module(f"bn{i}", bn(conv_ch))
            c = conv_ch
        self.concat_conv = conv(in_ch + num_convs * conv_ch, out_ch, 1)
        self.concat_bn = bn(out_ch)
        self.ese = ESE(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        y = x
        for i in range(self.num_convs):
            y = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y)))
            feats.append(y)
        y = F.relu(self.concat_bn(self.concat_conv(torch.cat(feats, dim=1))))
        y = self.ese(y)
        return y + x if self.identity else y


class VoVNet(nn.Module):
    """VoVNet V2; res3/4/5 are stages 3-5 (each after a 3x3/2 max-pool)."""

    def __init__(self, spec: str = "V-39-eSE"):
        super().__init__()
        stem, conv_ch, out_ch, n_convs, n_blocks = VOVNET_SPECS[spec]
        self.stem1 = conv(3, stem[0], 3, 2)
        self.stem1_bn = bn(stem[0])
        self.stem2 = conv(stem[0], stem[1], 3)
        self.stem2_bn = bn(stem[1])
        self.stem3 = conv(stem[1], stem[2], 3, 2)
        self.stem3_bn = bn(stem[2])
        self.blocks: List[List[str]] = []
        c = stem[2]
        for stage in range(4):
            names = []
            for b in range(n_blocks[stage]):
                names.append(f"stage{stage + 2}_block{b}")
                self.add_module(names[-1], OSABlock(c, conv_ch[stage], out_ch[stage], n_convs,
                                                    identity=b > 0))
                c = out_ch[stage]
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.stem1_bn(self.stem1(x)))
        y = F.relu(self.stem2_bn(self.stem2(y)))
        y = F.relu(self.stem3_bn(self.stem3(y)))
        outs = {}
        for stage, names in enumerate(self.blocks):
            if stage > 0:
                y = F.max_pool2d(y, 3, 2, padding=1)
            for name in names:
                y = getattr(self, name)(y)
            if stage >= 1:
                outs[f"res{stage + 2}"] = y
        return outs


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------

MBV2_CFG = [  # (expansion, out channels, blocks, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, expansion: int, out_ch: int, stride: int):
        super().__init__()
        hidden = in_ch * expansion
        self.residual = stride == 1 and in_ch == out_ch
        if expansion != 1:
            self.expand = conv(in_ch, hidden, 1)
            self.expand_bn = bn(hidden)
        else:
            self.expand = None
        self.dw = conv(hidden, hidden, 3, stride, groups=hidden)
        self.dw_bn = bn(hidden)
        self.project = conv(hidden, out_ch, 1)
        self.project_bn = bn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = F.relu6(self.expand_bn(self.expand(y)))
        y = F.relu6(self.dw_bn(self.dw(y)))
        y = self.project_bn(self.project(y))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2; res3 and res4 are the features entering the stride-2
    blocks at strides 8 and 16, res5 the last block's (stride 32)."""

    def __init__(self):
        super().__init__()
        self.stem = conv(3, 32, 3, 2)
        self.stem_bn = bn(32)
        self.taps = {}  # block index -> the res level of its input
        stride, idx, c = 2, 0, 32
        for e, out, n, s in MBV2_CFG:
            for b in range(n):
                blk_s = s if b == 0 else 1
                if blk_s == 2 and stride in (8, 16, 32):
                    self.taps[idx] = f"res{stride.bit_length() - 1}"
                stride *= blk_s
                self.add_module(f"block{idx}", InvertedResidual(c, e, out, blk_s))
                c = out
                idx += 1
        self.num_blocks = idx
        self.last = f"res{stride.bit_length() - 1}"

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu6(self.stem_bn(self.stem(x)))
        outs = {}
        for i in range(self.num_blocks):
            if i in self.taps:
                outs[self.taps[i]] = y
            y = getattr(self, f"block{i}")(y)
        outs[self.last] = y
        return {k: outs[k] for k in ("res3", "res4", "res5")}


# ---------------------------------------------------------------------------
# feature widths for the FPN
# ---------------------------------------------------------------------------


def feature_channels(kind: str, body: str = "", res2_out_channels: int = 256) -> Dict[str, int]:
    """The width of each trunk output, which the port's FPN takes up front
    (JAX's infers it): `kind` as ``models/build.py`` names it, `body` the
    DLA or VoVNet variant, `res2_out_channels` the ResNet's."""
    if kind in ("resnet", "resnet_lpf"):
        res2 = res2_out_channels if kind == "resnet" else 256  # ResNet-LPF's widths are fixed
        return {f"res{i}": res2 * 2 ** (i - 2) for i in range(2, 6)}
    if kind == "dla":
        widths = DLA_SPECS[body.upper()][1][3:]
    elif kind == "vovnet":
        widths = VOVNET_SPECS[body][2][1:]
    else:  # mobilenet: the inputs of the stride-2 blocks at strides 8 and 16, the last block
        widths = (MBV2_CFG[2][1], MBV2_CFG[4][1], MBV2_CFG[6][1])
    return dict(zip(("res3", "res4", "res5"), widths))
