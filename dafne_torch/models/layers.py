"""Layers that compute in their input's dtype with float32 parameters.

The JAX model keeps params in float32 and casts them to the compute dtype
(``TPU.COMPUTE_DTYPE``) at each use; these layers do the same, so one
float32 state dict serves both a float32 and a bfloat16 forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """Conv2d whose weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with float32 statistics, output in the input's dtype
    (flax upcasts to float32 for the statistics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class FrozenBN(nn.Module):
    """Frozen batch norm folded into y = x * mul + add.

    mul = weight / sqrt(var + eps) and add = bias - mean * mul are formed
    in float32 and cast to the compute dtype, as ``resnet.py:56-58`` of the
    JAX package does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * inv).to(x.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]
