"""Deformable 3x3 convolution (NCHW), counterpart of
``dafne_tpu/layers/deform_conv.py``.

A deformable 3x3 conv is a 1x1 conv over the 9 bilinearly sampled taps of
each location, stacked tap-major into columns [N, 9C, H, W]: tap k
(torchvision's (dy, dx) order, dy slow) samples the map at
(row + dy + offsets[:, 2k], col + dx + offsets[:, 2k + 1]).  The sampling,
``deform_im2col``, runs

  - on the card the hand-written kernel of ``dafne_torch/csrc/deform_conv.cu``
    (``ops/kernels/deform_conv.py``: forward and backward, through a
    ``torch.autograd.Function``), and
  - on the CPU its plain version ``deform_im2col_plain``: JAX's gather
    formulation, op for op.  On the card it is the kernel's reference.

A CUDA tensor launches the kernel or raises; there is no fallback.

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
from dafne_torch.ops.kernels import deform_conv as K

#: the 9 taps' base offsets (dy, dx), torchvision's order
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def bilinear_sample(x: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Sample x [N, C, H, W] at float positions px, py [N, H', W'] (pixel
    index space, 0..W-1) -> [N, C, H', W'], as JAX's ``bilinear_sample``
    (which is NHWC): a corner outside the map gathers index 0 and is
    multiplied by 0."""
    n, c, h, w = x.shape
    px = px.float()
    py = py.float()
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    wx = px - x0f
    wy = py - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = x0 + 1
    y1 = y0 + 1
    flat = x.reshape(n, c, h * w)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = torch.where(inb, yi * w + xi, 0).reshape(n, 1, -1).expand(n, c, -1)
        out = torch.gather(flat, 2, idx).reshape((n, c) + tuple(px.shape[1:]))
        return out * inb[:, None].to(out.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    wx = wx[:, None].to(x.dtype)
    wy = wy[:, None].to(x.dtype)
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )


def deform_im2col_plain(x: torch.Tensor, offsets: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Columns [N, 9C, H, W] (tap-major) of x [N, C, H, W] sampled at the
    3x3 grid moved by offsets [N, 18, H, W] ((dy, dx) per tap, read as
    float32), each tap times mask [N, 9, H, W] (x's dtype) when given."""
    n, c, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    taps = []
    for k, (dy, dx) in enumerate(TAPS):
        py = gy + dy + offsets[:, 2 * k].float()
        px = gx + dx + offsets[:, 2 * k + 1].float()
        t = bilinear_sample(x, px, py)
        if mask is not None:
            t = t * mask[:, k:k + 1]
        taps.append(t)
    return torch.cat(taps, dim=1)


def deform_im2col(x: torch.Tensor, offsets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The columns of ``deform_im2col_plain``: the CUDA kernel (with its
    backward) for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return K.deform_im2col_cuda(x, offsets.float(), mask)
    if x.device.type == "cpu":
        return deform_im2col_plain(x, offsets, mask)
    raise ValueError(f"deform_im2col: unsupported device {x.device}")


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
