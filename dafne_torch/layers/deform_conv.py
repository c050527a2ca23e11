"""Deformable 3x3 convolution (NCHW), counterpart of
``dafne_tpu/layers/deform_conv.py``.

A deformable 3x3 conv is a 1x1 conv over the 9 bilinearly sampled taps of
each location, stacked tap-major into columns [N, 9C, H, W]: tap k
(torchvision's (dy, dx) order, dy slow) samples the map at
(row + dy + offsets[:, 2k], col + dx + offsets[:, 2k + 1]).  The sampling,
``deform_im2col``, runs

  - on the card the hand-written kernel of ``dafne_torch/csrc/deform_conv.cu``
    (``ops/kernels/deform_conv.py``: forward and backward), and
  - on the CPU its plain version ``deform_im2col_plain``
    (``ops/kernels/deform_conv.py``): JAX's gather formulation, op for op.
    On the card it is the kernel's reference.

Both sit behind the op ``dafne::deform_im2col`` (``ops/kernels/library.py``),
whose device key picks one and whose autograd runs
``dafne::deform_im2col_backward``.  A CUDA tensor launches the kernel or
raises; there is no fallback.

Semantics, as JAX's ``bilinear_sample``: positions and the fractional
weights wx, wy are float32 whatever the feature dtype; each of the four
corners is weighted 0 when it falls outside the map (never clamped); then
wx and wy are cast to the feature dtype and the sum
v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy is taken in
that dtype, each op rounded to it, in that order.

The offset generators (``ltrb_to_offsets`` ... ``corners_to_offsets``) keep
JAX's NHWC layout [N, H, W, 18]; ``DeformConv2d`` takes NCHW offsets
[N, 18, H, W].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dafne_torch.models.layers import Conv2d
from dafne_torch.ops.kernels.deform_conv import (  # noqa: F401  (the plain version's home)
    TAPS,
    bilinear_sample,
    deform_im2col_plain,
)

def deform_im2col(x: torch.Tensor, offsets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The columns of ``deform_im2col_plain`` through ``dafne::deform_im2col``:
    the CUDA kernel (with its backward) for CUDA tensors, the plain version
    (with its autograd's gradients) for CPU tensors."""
    return torch.ops.dafne.deform_im2col(x, offsets, mask)


class DeformConv2d(nn.Module):
    """3x3 deformable conv, stride 1, as JAX's ``DeformConv2d``: the learned
    ``offset_conv`` (3x3, 18 channels, with bias; zero-initialised, so it
    starts as a regular 3x3 conv), used unless offsets are passed, an
    optional modulation mask, and the bias-free 1x1 ``weight`` conv over
    the 9C stacked taps.  ``forward(x, offsets=None, mask=None)``: offsets
    NCHW [N, 18, H, W], mask [N, 9, H, W]."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.offset_conv = Conv2d(in_channels, 18, 3, padding=1)
        self.weight = Conv2d(9 * in_channels, features, 1, bias=False)

    def forward(self, x: torch.Tensor, offsets: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if offsets is None:
            offsets = self.offset_conv(x)
        return self.weight(deform_im2col(x, offsets, mask))


# ---------------------------------------------------------------------------
# geometry -> offset generators (NHWC, as JAX's)
# ---------------------------------------------------------------------------


def _grid_offsets(py, px, h, w, dtype):
    """Absolute 3x3 target positions [N, H, W, 3, 3] -> offsets relative to
    each location [N, H, W, 18], interleaved (dy, dx).  As in JAX, the
    base term of each tap stays in: the conv adds it again on top."""
    gy = torch.arange(h, dtype=dtype, device=py.device)[None, :, None, None, None]
    gx = torch.arange(w, dtype=dtype, device=px.device)[None, None, :, None, None]
    inter = torch.stack([py - gy, px - gx], dim=-1)  # [N, H, W, 3, 3, 2]
    return inter.reshape(inter.shape[:3] + (18,))


def _box_grid(x0, y0, x1, y1, shape, dtype):
    fr = torch.tensor([0.0, 0.5, 1.0], dtype=dtype, device=x0.device)
    py = y0[..., None, None] + (y1 - y0)[..., None, None] * fr.reshape(1, 1, 1, 3, 1)
    px = x0[..., None, None] + (x1 - x0)[..., None, None] * fr.reshape(1, 1, 1, 1, 3)
    return py.expand(shape + (3, 3)), px.expand(shape + (3, 3))


def ltrb_to_offsets(ltrb: torch.Tensor, stride: float = 1.0) -> torch.Tensor:
    """A 3x3 grid spanning the (l, t, r, b) box around each location; ltrb
    [N, H, W, 4] in feature-map units -> [N, H, W, 18]."""
    n, h, w, _ = ltrb.shape
    dtype = ltrb.dtype
    gy = torch.arange(h, dtype=dtype, device=ltrb.device)[None, :, None]
    gx = torch.arange(w, dtype=dtype, device=ltrb.device)[None, None, :]
    l, t, r, b = [ltrb[..., i] / stride for i in range(4)]
    py, px = _box_grid(gx - l, gy - t, gx + r, gy + b, (n, h, w), dtype)
    return _grid_offsets(py, px, h, w, dtype)


def hbox_to_offsets(hbox: torch.Tensor, stride: float = 1.0) -> torch.Tensor:
    """A 3x3 grid over the absolute hbox (x0, y0, x1, y1) of each location."""
    n, h, w, _ = hbox.shape
    x0, y0, x1, y1 = [hbox[..., i] / stride for i in range(4)]
    py, px = _box_grid(x0, y0, x1, y1, (n, h, w), hbox.dtype)
    return _grid_offsets(py, px, h, w, hbox.dtype)


def center_to_offsets(center: torch.Tensor, stride: float = 1.0) -> torch.Tensor:
    """The whole 3x3 grid shifted by the predicted center offset [N, H, W, 2]
    (x, y)."""
    off = torch.stack([center[..., 1] / stride, center[..., 0] / stride], -1)  # (dy, dx)
    return off.repeat(1, 1, 1, 9)


def corners_to_offsets(corners: torch.Tensor, stride: float = 1.0) -> torch.Tensor:
    """Samples at the 4 predicted corners [N, H, W, 8] (x, y per corner,
    relative to each location), their 4 midpoints and their center."""
    cs = (corners / stride).reshape(corners.shape[:3] + (4, 2))
    mids = 0.5 * (cs + torch.roll(cs, -1, dims=-2))
    center = cs.mean(-2, keepdim=True)
    pts = torch.cat([cs, mids, center], dim=-2)  # 9 points (x, y)
    off = torch.stack([pts[..., 1], pts[..., 0]], -1)  # (dy, dx)
    return off.reshape(off.shape[:3] + (18,))
