"""Model builder: config -> OneStageDetector, counterpart of
``dafne_tpu/models/build.py``: JAX's registry of MODEL.BACKBONE.NAME
(ResNet-18..152, the deformable-interval ResNet, ResNet-LPF under
ANTI_ALIAS, DLA, VoVNet, MobileNetV2), every head option (deformable
towers included) and the TOP_MODULE conv.  MODEL.RESNETS.NORM other than
FrozenBN and RES5_DILATION other than 1 raise: JAX reads neither key."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dafne_torch.layers import deform_conv
from dafne_torch.models import backbones as B
from dafne_torch.models.fpn import FPN
from dafne_torch.models.head import DAFNeHead
from dafne_torch.models.layers import BatchNorm, Conv2d
from dafne_torch.models.one_stage_detector import OneStageDetector
from dafne_torch.models.resnet import ResNet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

#: MODEL.BACKBONE.NAME -> trunk kind, JAX's registry (build.py:28-40); the
#: resnet names take ANTI_ALIAS to "resnet_lpf"
BACKBONE_KINDS = {
    "build_dafne_resnet_fpn_backbone": "resnet",
    "build_resnet_interval_backbone": "resnet",
    "build_resnet_lpf_backbone": "resnet_lpf",
    "build_dafne_dla_fpn_backbone": "dla",
    "build_dla_fpn_backbone": "dla",
    "build_vovnet_fpn_backbone": "vovnet",
    "build_fcos_vovnet_fpn_backbone": "vovnet",
    "build_mnv2_backbone": "mobilenet",
    "build_mobilenetv2_fpn_backbone": "mobilenet",
}


def build_backbone(cfg):
    """(trunk, {output: channels}) of MODEL.BACKBONE.NAME."""
    name = cfg.MODEL.BACKBONE.NAME
    if name not in BACKBONE_KINDS:
        raise ValueError(f"Unknown MODEL.BACKBONE.NAME: {name}")
    kind = BACKBONE_KINDS[name]
    if kind == "resnet" and cfg.MODEL.BACKBONE.ANTI_ALIAS:
        kind = "resnet_lpf"
    r = cfg.MODEL.RESNETS
    if kind == "resnet":
        interval = (max(1, r.DEFORM_INTERVAL) if name == "build_resnet_interval_backbone"
                    else 0)
        trunk = ResNet(
            depth=r.DEPTH, out_features=r.OUT_FEATURES, num_groups=r.NUM_GROUPS,
            width_per_group=r.WIDTH_PER_GROUP, stem_out_channels=r.STEM_OUT_CHANNELS,
            res2_out_channels=r.RES2_OUT_CHANNELS, stride_in_1x1=r.STRIDE_IN_1X1,
            deform_interval=interval,
        )
        return trunk, B.feature_channels(kind, res2_out_channels=r.RES2_OUT_CHANNELS)
    if kind == "resnet_lpf":
        trunk = B.ResNetLPF(r.DEPTH, r.OUT_FEATURES, cfg.MODEL.BACKBONE.FREEZE_AT)
        return trunk, B.feature_channels(kind)
    if kind == "dla":
        return B.DLA(cfg.MODEL.DLA.CONV_BODY), B.feature_channels(kind, cfg.MODEL.DLA.CONV_BODY)
    if kind == "vovnet":
        body = cfg.MODEL.VOVNET.CONV_BODY
        return B.VoVNet(body), B.feature_channels(kind, body)
    return B.MobileNetV2(), B.feature_channels(kind)


def build_model(cfg, device="cuda", generator: Optional[torch.Generator] = None) -> OneStageDetector:
    """Build the detector of a config on `device`, in eval mode, with
    weights drawn from `generator` (a seeded CPU generator) by the JAX
    package's initializers; load trained weights over them with
    ``load_state_dict``."""
    if cfg.MODEL.META_ARCHITECTURE != "OneStageDetector":
        raise ValueError(f"Unknown MODEL.META_ARCHITECTURE {cfg.MODEL.META_ARCHITECTURE}")
    unported = {
        "MODEL.RESNETS.NORM": cfg.MODEL.RESNETS.NORM != "FrozenBN",
        "MODEL.RESNETS.RES5_DILATION": cfg.MODEL.RESNETS.RES5_DILATION != 1,
    }
    for key, bad in unported.items():
        if bad:
            raise NotImplementedError(f"{key} setting not ported yet")
    r = cfg.MODEL.RESNETS
    d = cfg.MODEL.DAFNE
    backbone, channels = build_backbone(cfg)
    fpn = FPN(
        channels, in_features=r.OUT_FEATURES, out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        top_block={2: "p6p7", 1: "p6", 0: ""}[d.TOP_LEVELS], fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )
    head = DAFNeHead(
        num_classes=d.NUM_CLASSES, num_levels=len(d.IN_FEATURES),
        in_channels=cfg.MODEL.FPN.OUT_CHANNELS, num_cls_convs=d.NUM_CLS_CONVS,
        num_box_convs=d.NUM_BOX_CONVS, num_share_convs=d.NUM_SHARE_CONVS, norm=d.NORM,
        use_scale=d.USE_SCALE, prior_prob=d.PRIOR_PROB, corner_prediction=d.CORNER_PREDICTION,
        corner_tower_on_center_tower=d.CORNER_TOWER_ON_CENTER_TOWER,
        merge_corner_center_pred=d.MERGE_CORNER_CENTER_PRED, centerness=d.CENTERNESS,
        ctr_on_reg=d.CTR_ON_REG, use_deformable=d.USE_DEFORMABLE, use_relu=d.USE_RELU,
    )
    top = cfg.MODEL.TOP_MODULE
    if top.NAME not in ("", "conv"):
        raise ValueError(f"Unknown MODEL.TOP_MODULE.NAME {top.NAME!r}")
    top_module = (Conv2d(cfg.MODEL.FPN.OUT_CHANNELS, top.DIM, 3, padding=1)
                  if top.NAME == "conv" else None)
    model = OneStageDetector(
        backbone, fpn, head, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, d.IN_FEATURES,
        dtype=DTYPES[cfg.TPU.COMPUTE_DTYPE], top_module=top_module,
    )
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval()


@torch.no_grad()
def init_weights(model: OneStageDetector, generator: torch.Generator) -> None:
    """The JAX package's initializers: backbone convs He-normal on fan-out,
    depthwise ones included (the ResNet stem and the TOP_MODULE conv
    LeCun-normal), FPN convs uniform on fan-in, head convs normal(0.01) with
    zero bias and the focal prior on the class bias; in every
    ``DeformConv2d`` the offset conv zeros and the 1x1 normal(0.01); ESE's
    Dense flax's default (LeCun truncated normal, zero bias); GN and BN
    affines 1 and 0, BN running mean 0 and variance 1."""
    lecun = {"top_module"}
    if isinstance(model.backbone, ResNet):
        lecun.add("backbone.stem_conv1")
    for name, m in model.named_modules():
        if not isinstance(m, Conv2d):
            continue
        w = m.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        fan_out = w.shape[0] * w.shape[2] * w.shape[3]
        if name in lecun:
            w.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
        elif name.startswith("backbone."):
            w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif name.startswith("fpn."):
            bound = math.sqrt(3.0 / fan_in)
            w.uniform_(-bound, bound, generator=generator)
        else:
            w.normal_(0.0, 0.01, generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    for m in model.modules():
        if isinstance(m, deform_conv.DeformConv2d):
            m.weight.weight.normal_(0.0, 0.01, generator=generator)
            m.offset_conv.weight.zero_()
            m.offset_conv.bias.zero_()
        if isinstance(m, B.ESE):
            # flax's lecun_normal: a normal truncated at +-2 std, scaled to
            # variance 1 / fan_in
            std = math.sqrt(1.0 / m.fc.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.fc.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.fc.bias.zero_()
    model.head.cls_logits.bias.fill_(model.head.prior_bias)
    for m in model.modules():
        if isinstance(m, (nn.GroupNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
