"""One-stage detector: normalize -> ResNet -> FPN -> DAFNe head.

Counterpart of ``dafne_tpu/models/one_stage_detector.py``.  Takes raw-pixel
images [N, H, W, 3] and returns the JAX module's per-level dict in NHWC
(``logits [N,H,W,C]``, ``corners [..,8]``, ``center [..,2]`` or None,
``ctrness [..,1]``, and with a ``top_module`` conv (MODEL.TOP_MODULE)
``top_feats [..,DIM]`` of each FPN level) in float32, plus ``hw``.  Inside,
it runs NCHW in `dtype` with float32 parameters.  ``forward(images,
train)``: `train` reaches the head's towers, as JAX's ``train=`` does (BN
towers normalize with the batch's statistics and move the running ones).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from dafne_torch.models.fpn import FPN
from dafne_torch.models.head import DAFNeHead
from dafne_torch.models.layers import Conv2d
from dafne_torch.models.resnet import ResNet


class OneStageDetector(nn.Module):
    def __init__(self, backbone: ResNet, fpn: FPN, head: DAFNeHead,
                 pixel_mean: Sequence[float], pixel_std: Sequence[float],
                 in_features: Sequence[str], dtype: torch.dtype = torch.float32,
                 top_module: Optional[Conv2d] = None):
        super().__init__()
        self.backbone = backbone
        self.fpn = fpn
        self.head = head
        self.top_module = top_module
        self.in_features = tuple(in_features)
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32),
                             persistent=False)

    def forward(self, images: torch.Tensor, train: bool = False) -> Dict[str, Any]:
        x = images.to(self.dtype)
        x = (x - self.pixel_mean.to(self.dtype)) / self.pixel_std.to(self.dtype)
        x = x.permute(0, 3, 1, 2).contiguous()
        pyramid = self.fpn(self.backbone(x))
        levels = [pyramid[f] for f in self.in_features]
        out = self.head(levels, train)
        if self.top_module is not None:
            out["top_feats"] = [self.top_module(f) for f in levels]
        out = {
            k: [None if t is None else t.permute(0, 2, 3, 1).float().contiguous() for t in v]
            for k, v in out.items()
        }
        out["hw"] = [tuple(f.shape[2:]) for f in levels]
        return out
