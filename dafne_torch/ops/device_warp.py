"""Separable image warps rendered on the device from one base image.

Counterpart of ``dafne_tpu/ops/device_warp.py``.  Every augmentation of
the DAFNe TTA set ({multi-scale resize} x {identity, hflip, vflip,
rot90 multiples}) and of the rot90-only train recipes is an affine map
whose linear part is a signed (anti)diagonal, so the warp factors into an
optional transpose plus one independent bilinear resample per axis:

  out[i, j] = sum_taps w_h[i] * w_w[j] * transpose?(img)[idx_h[i], idx_w[j]]

with exactly two taps per output row and per output column.  The host
computes the taps (``separable_warp_params``: a few KB per copy) and the
device renders every copy from the one shipped base image.

Host side (numpy): ``SeparableWarp``, ``_axis_params``,
``separable_warp_params``, ``stack_warps`` and ``draw_color_params``
(:44-151, :218-235).  Device side (torch): ``device_warp`` (the k copies of
one image, TTA), ``device_warp_batch`` (one warp per image of a batch,
train-time augmentation) and ``device_color_aug`` (:168-281).

The JAX package builds [k, canvas, src] one-hot matrices and multiplies
them at HIGHEST precision, a TPU workaround for gathers.  Here each axis
is two gathers and a weighted sum in float32, h first and then w, the
order of the JAX einsums: ``w0 * x[idx0] + w1 * x[idx1]`` as separate
multiplies and one add, with no matmul and so no TF32.  Against the JAX
function this differs by at most about an ulp per tap (its dot over a
one-hot row adds exact zeros and may fuse a product into an FMA).  A tap
weight below 2^-24 (``TAP_EPS``, under float32's resolution of a unit
weight) counts as 0: a 90-degree rotation's composed matrix carries
cos(90 deg) = 6e-17, which puts a sample ~1e-14 past a pixel center, and
that weight would otherwise leave ~1e-12 where the host copy has exact
zeros.  So at unit scale every weight is 1 or 0 and the copy is exact.

Sampling follows cv2's INTER_LINEAR grid (half-pixel centers): source x of
output center j is A^-1 (j + 0.5) - 0.5.  Canonical grids replicate the
edge pixel (cv2.resize); others are zero outside the source
(cv2.warpAffine).  Rows and columns beyond the copy's output extent have
zero weights: the zero padding the eval step expects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dafne_torch.data.transforms import _LIGHTING_EIGEN_VALS, _LIGHTING_EIGEN_VECS, AffineAug

_EPS = 1e-9
TAP_EPS = 2.0 ** -24  # tap weights below this render as 0
WARP_KEYS = ("idx0_h", "idx1_h", "w0_h", "w1_h", "idx0_w", "idx1_w", "w0_w", "w1_w")


@dataclasses.dataclass
class SeparableWarp:
    """One copy's taps: canvas-length index and weight vectors per axis."""

    transpose: bool
    idx0_h: np.ndarray  # [canvas_h] int32, clamped to [0, src_h - 1]
    idx1_h: np.ndarray
    w0_h: np.ndarray  # [canvas_h] float32 (0 beyond out_h)
    w1_h: np.ndarray
    idx0_w: np.ndarray
    idx1_w: np.ndarray
    w0_w: np.ndarray
    w1_w: np.ndarray
    out_h: int
    out_w: int


def _axis_params(scale: float, offset: float, out_n: int, src_n: int, canvas_n: int,
                 replicate: bool):
    """Bilinear taps of one axis, src = scale * dst + offset at pixel
    centers.  `replicate` clamps taps to the edge pixel; otherwise a tap
    outside the source weighs zero."""
    j = np.arange(canvas_n, dtype=np.float64)
    xs = scale * j + offset
    x0 = np.floor(xs)
    w1 = (xs - x0).astype(np.float32)
    w0 = 1.0 - w1
    if not replicate:
        w0 = w0 * ((x0 >= 0) & (x0 <= src_n - 1))
        w1 = w1 * ((x0 + 1 >= 0) & (x0 + 1 <= src_n - 1))
    idx0 = np.clip(x0, 0, src_n - 1).astype(np.int32)
    idx1 = np.clip(x0 + 1, 0, src_n - 1).astype(np.int32)
    live = (j < out_n).astype(np.float32)
    return idx0, idx1, w0.astype(np.float32) * live, w1.astype(np.float32) * live


def separable_warp_params(aug: AffineAug, src_w: int, src_h: int,
                          canvas_hw: Tuple[int, int]) -> Optional[SeparableWarp]:
    """`aug` as per-axis taps onto a `canvas_hw` canvas, or None when its
    linear part is not a signed (anti)diagonal (a general-angle rotation)."""
    lin, t = aug.matrix[:, :2], aug.matrix[:, 2]
    if abs(lin[0, 1]) < _EPS and abs(lin[1, 0]) < _EPS:
        transpose = False
        sx, sy = lin[0, 0], lin[1, 1]
    elif abs(lin[0, 0]) < _EPS and abs(lin[1, 1]) < _EPS:
        transpose = True
        sx, sy = lin[0, 1], lin[1, 0]
    else:
        return None
    if abs(sx) < _EPS or abs(sy) < _EPS:
        return None
    # image-space affine at pixel centers, A(x) = M(x + 0.5) - 0.5, inverted
    # per axis; with a transpose the x output samples the source's row axis
    bx = sx * 0.5 + t[0] - 0.5
    by = sy * 0.5 + t[1] - 0.5
    canvas_h, canvas_w = canvas_hw
    a0_n = src_w if transpose else src_h
    a1_n = src_h if transpose else src_w
    # a canonical grid (|s| * src == out, canonical flip offsets) renders as
    # cv2.resize does (edge replicate); anything else as cv2.warpAffine (zero)
    canonical = (
        abs(abs(sx) * a1_n - aug.out_w) <= 1e-6 * max(aug.out_w, 1)
        and abs(abs(sy) * a0_n - aug.out_h) <= 1e-6 * max(aug.out_h, 1)
        and abs(t[0] - (aug.out_w if sx < 0 else 0.0)) <= 1e-6
        and abs(t[1] - (aug.out_h if sy < 0 else 0.0)) <= 1e-6
    )
    idx0_h, idx1_h, w0_h, w1_h = _axis_params(1.0 / sy, -by / sy, aug.out_h, a0_n, canvas_h,
                                              canonical)
    idx0_w, idx1_w, w0_w, w1_w = _axis_params(1.0 / sx, -bx / sx, aug.out_w, a1_n, canvas_w,
                                              canonical)
    return SeparableWarp(transpose, idx0_h, idx1_h, w0_h, w1_h, idx0_w, idx1_w, w0_w, w1_w,
                         aug.out_h, aug.out_w)


def stack_warps(warps) -> Dict[str, np.ndarray]:
    """k warps of one transpose and one canvas as the [k, canvas] arrays
    ``device_warp`` takes."""
    assert len({w.transpose for w in warps}) == 1
    return {k: np.stack([getattr(w, k) for w in warps]) for k in WARP_KEYS}


def draw_color_params(rng) -> Dict[str, np.ndarray]:
    """The color jitter's random draws, taken from `rng` in the order
    ``transforms.apply_color_augmentations`` takes them, so one example seed
    gives the same jitter on the host and on the device."""
    weights = rng.normal(scale=1.0, size=3)
    light = _LIGHTING_EIGEN_VECS.dot(weights * _LIGHTING_EIGEN_VALS)
    return {
        "color_light": light.astype(np.float32),  # additive per-channel shift
        # brightness, contrast and saturation blend weights, in d2's order
        "color_w": np.asarray([rng.uniform(0.5, 1.5) for _ in range(3)], np.float32),
    }


def warp_tensors(p: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Stacked taps as tensors on `device`: indices int64, weights float32."""
    return {k: torch.as_tensor(p[k], device=device).to(
        torch.int64 if k.startswith("idx") else torch.float32) for k in WARP_KEYS}


def _taps(a0: torch.Tensor, a1: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor):
    """w0 * a0 + w1 * a1 (weights under TAP_EPS as 0): two multiplies and
    one add, unfused."""
    w0 = torch.where(w0 < TAP_EPS, torch.zeros_like(w0), w0)
    w1 = torch.where(w1 < TAP_EPS, torch.zeros_like(w1), w1)
    return w0 * a0 + w1 * a1


def _resample_w(y: torch.Tensor, p) -> torch.Tensor:
    """Columns of y [k, Ch, S1, 3] with per-copy taps [k, Cw]."""
    k, ch, _, c = y.shape
    cw = p["idx0_w"].shape[1]

    def take(idx):
        return torch.gather(y, 2, idx.long()[:, None, :, None].expand(k, ch, cw, c))

    return _taps(take(p["idx0_w"]), take(p["idx1_w"]), p["w0_w"][:, None, :, None],
                 p["w1_w"][:, None, :, None])


@torch.no_grad()
def device_warp(img: torch.Tensor, p, transpose: bool) -> torch.Tensor:
    """The k copies of one base image.

    img: [src_h, src_w, 3] uint8 or float; p: ``warp_tensors`` of
    ``stack_warps`` ([k, canvas_*]) on img's device; `transpose` applies to
    every copy.  Returns [k, canvas_h, canvas_w, 3] float32."""
    x = img.float()
    if transpose:
        x = x.transpose(0, 1)
    k, ch = p["idx0_h"].shape

    def rows(idx):
        return x.index_select(0, idx.reshape(-1)).reshape(k, ch, *x.shape[1:])

    y = _taps(rows(p["idx0_h"]), rows(p["idx1_h"]), p["w0_h"][:, :, None, None],
              p["w1_h"][:, :, None, None])
    return _resample_w(y, p)


@torch.no_grad()
def device_warp_batch(imgs: torch.Tensor, p) -> torch.Tensor:
    """One warp per image of a batch (train-time augmentation).

    imgs: [B, S0, S1, 3] uint8 or float base images, already transposed on
    the host where a draw is anti-diagonal (the taps describe the source
    after that transpose); p: [B, canvas_*] taps on imgs' device.  Returns
    [B, canvas_h, canvas_w, 3] float32, zero beyond each output extent."""
    x = imgs.float()
    b, _, s1, c = x.shape
    ch = p["idx0_h"].shape[1]

    def rows(idx):
        return torch.gather(x, 1, idx.long()[:, :, None, None].expand(b, ch, s1, c))

    y = _taps(rows(p["idx0_h"]), rows(p["idx1_h"]), p["w0_h"][:, :, None, None],
              p["w1_h"][:, :, None, None])
    return _resample_w(y, p)


@torch.no_grad()
def device_color_aug(img: torch.Tensor, light: torch.Tensor, w: torch.Tensor,
                     out_hw: torch.Tensor) -> torch.Tensor:
    """Detectron2's color jitter (INPUT.USE_COLOR_AUGMENTATIONS) on warped
    canvases, as ``transforms.apply_color_augmentations`` applies it:
    RandomLighting(1.0), RandomBrightness, RandomContrast, RandomSaturation,
    each clipped to [0, 255] and truncated between stages.  Every stage is
    masked to the live [out_h, out_w] region and the contrast mean is taken
    over the live pixels.  float32 per stage where the host uses float64:
    at most one intensity level apart.

    img [B, Ch, Cw, 3] float32; light [B, 3]; w [B, 3] (brightness,
    contrast, saturation); out_hw [B, 2] int."""
    b, ch, cw, _ = img.shape
    oh = out_hw[:, 0].view(b, 1, 1, 1)
    ow = out_hw[:, 1].view(b, 1, 1, 1)
    ih = torch.arange(ch, device=img.device).view(1, ch, 1, 1)
    iw = torch.arange(cw, device=img.device).view(1, 1, cw, 1)
    mask = ((ih < oh) & (iw < ow)).float()
    live = (oh * ow * 3).float()

    def stage(y):  # d2's uint8 round trip between stages: clip, then truncate
        return torch.floor(torch.clamp(y, 0.0, 255.0)) * mask

    x = stage(torch.round(img))  # the host's warped image is uint8
    x = stage(x + light[:, None, None, :])
    wb, wc, ws = (w[:, i].view(b, 1, 1, 1) for i in range(3))
    x = stage(wb * x)
    mean = x.sum(dim=(1, 2, 3), keepdim=True) / live
    x = stage((1.0 - wc) * mean + wc * x)
    gray = (x * torch.tensor([0.299, 0.587, 0.114], device=img.device)).sum(-1, keepdim=True)
    return stage((1.0 - ws) * gray + ws * x)
