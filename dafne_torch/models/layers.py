"""Layers that compute in their input's dtype with float32 parameters.

The JAX model keeps params in float32 and casts them to the compute dtype
(``TPU.COMPUTE_DTYPE``) at each use; these layers do the same, so one
float32 state dict serves both a float32 and a bfloat16 forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dafne_torch.parallel.distributed import GlobalSum, process_count


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
    JAX package does.

    In JAX all four are parameters, and the optimizer's labels freeze the
    ones under a module named ``*norm*``.  The ResNet trunks name theirs so
    (here buffers); DLA, VoVNet and MobileNetV2 name theirs ``*_bn``, so JAX
    trains their ``weight`` and ``bias`` (``affine_params``: parameters
    here) and keeps only the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, affine_params: bool = False):
        super().__init__()
        self.eps = eps
        if affine_params:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_buffer("weight", torch.ones(features))
            self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * inv).to(x.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, x * tanh(softplus(x)): the towers' activation under
    MODEL.DAFNE.USE_RELU False (``dafne_tpu/models/head.py:44-47``)."""
    return F.mish(x)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    ``forward(x, train)``: with `train` the batch's statistics normalize and
    the running ones move, ``running = 0.9 * running + 0.1 * batch``;
    without it the running statistics normalize (flax's
    ``use_running_average = not train``).  As flax 0.12.3's
    ``_compute_stats`` (``use_fast_variance``, ``force_float32_reductions``)
    the statistics are at least float32 whatever the compute dtype, the variance is
    E[x^2] - E[x]^2 clipped at 0, and the running variance takes that
    biased variance.  ``F.batch_norm`` would take the unbiased one, in two
    passes, so this is written out; there is no ``num_batches_tracked``.
    The output is in the input's dtype.  With several processes the
    training statistics are those of the global batch, as under JAX's one
    SPMD program: the float32 sums of x and x^2 and the count are summed
    over the processes, the gradient flowing back through that sum
    (``parallel.distributed.GlobalSum``)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            if process_count() > 1:
                count = torch.full((1,), x.numel() // x.shape[1], dtype=xf.dtype, device=x.device)
                sums = GlobalSum.apply(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                                                  count]))
                c = x.shape[1]
                mean, mean2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
            else:
                mean = xf.mean((0, 2, 3))
                mean2 = (xf * xf).mean((0, 2, 3))
            var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
