"""The deformable sampling kernel (``deform_im2col``) and its plain version.

The CUDA kernels of ``dafne_torch/csrc/deform_conv.cu`` behind wrappers
that check their inputs, launch on the current stream, raise on a launch
error and count their launches (``deform_im2col_forward_cuda.launches``,
``deform_im2col_backward_cuda.launches``), and the plain PyTorch version
``deform_im2col_plain`` (JAX's gather formulation, op for op; semantics
in ``dafne_torch/layers/deform_conv.py``).  ``library.py`` joins them into
the ops ``dafne::deform_im2col`` and ``dafne::deform_im2col_backward``,
the forward differentiable through the backward.

No Pallas kernel is replaced: JAX samples in XLA
(``dafne_tpu/layers/deform_conv.py:26``).  The forward is bit-equal to the
plain version.  The backward's gradient of x sums with float32 atomics in
no fixed order, and it reduces the offsets' and the mask's gradients over
the channels in float32, where the plain version's autograd rounds its
products to the feature dtype: it agrees with the plain version's autograd
within a tolerance, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dafne_torch.ops.kernels.build import check_cuda, load

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: f32 operations per column element (one tap of one channel at one
#: pixel), each add, sub and mul counted as 1; a rounding to the feature
#: dtype, a load and the per-pixel position (shared by the channels) are
#: not counted.  Forward: the 4 corners times their 0/1 factors (4), the 8
#: products and 3 sums of the interpolation (11); the mask 1 more.
#: Backward: the corners (4), the masked gradient (1), each of the two
#: weight gradients 2 sub, 2 mul, 1 add, the product with the gradient and
#: the running sum (14), the 4 corner shares and their 4 atomic adds (8);
#: with a mask the sample again (11), its product and sum (2).
OPS_FORWARD, OPS_FORWARD_MASK = 15, 1
OPS_BACKWARD, OPS_BACKWARD_MASK = 27, 13


#: the forward's kernels, in launch order: the channels-last copy of x,
#: then the gather (a profiler trace of one call holds both)
FORWARD_KERNELS = ("deform_im2col_nhwc_kernel", "deform_im2col_gather_kernel")


def forward_bytes(n: int, c: int, h: int, w: int, itemsize: int, mask: bool) -> int:
    """The forward's bytes, each input read once and the columns written
    once: x, the f32 offsets, the mask, the 9C columns."""
    hw = n * h * w
    return hw * (c * itemsize + 18 * 4 + (9 * itemsize if mask else 0) + 9 * c * itemsize)


def backward_bytes(n: int, c: int, h: int, w: int, itemsize: int, mask: bool) -> int:
    """The backward's bytes, each read once and each gradient written once
    in its tensor's dtype: the columns' gradient, x, the offsets and the
    mask read; the gradients of x, the offsets and the mask written."""
    hw = n * h * w
    return hw * (9 * c * itemsize + 2 * c * itemsize + 2 * 18 * 4
                 + (2 * 9 * itemsize if mask else 0))


def _lib():
    lib = load("deform_conv")
    if not getattr(lib, "_dafne_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dafne_deform_im2col.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.dafne_deform_im2col.restype = i
        lib.dafne_deform_im2col_backward.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.dafne_deform_im2col_backward.restype = i
        lib._dafne_typed = True
    return lib


def _check(x: torch.Tensor, offsets: torch.Tensor, mask: Optional[torch.Tensor]):
    if x.dim() != 4 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"deform_im2col: expected x [N, C, H, W] in {list(DTYPE_CODES)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    n, c, h, w = x.shape
    if min(n, c, h, w) < 1:
        raise ValueError(f"deform_im2col: empty x {tuple(x.shape)}")
    check_cuda("x", x, x.dtype, (n, c, h, w))
    check_cuda("offsets", offsets, torch.float32, (n, 18, h, w))
    if mask is not None:
        check_cuda("mask", mask, x.dtype, (n, 9, h, w))
    if offsets.device != x.device or (mask is not None and mask.device != x.device):
        raise ValueError("deform_im2col: inputs on different devices")
    return n, c, h, w


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def nhwc_channels(c: int, dtype: torch.dtype) -> int:
    """The channels of a pixel in the forward's channels-last copy of x: C
    rounded up to 16 bytes, one load of a lane."""
    per_load = 128 // torch.finfo(dtype).bits
    return -(-c // per_load) * per_load


def deform_im2col_forward_cuda(x: torch.Tensor, offsets: torch.Tensor,
                               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Columns [N, 9C, H, W] in x's dtype (see ``deform_im2col_plain``);
    x contiguous f32/bf16/f16, offsets contiguous f32 [N, 18, H, W], mask
    None or contiguous [N, 9, H, W] in x's dtype, all on one CUDA device.
    The kernel gathers from a channels-last copy of x made in the same
    call, in scratch allocated here."""
    n, c, h, w = _check(x, offsets, mask)
    lib = _lib()
    with torch.cuda.device(x.device):
        cols = torch.empty((n, 9 * c, h, w), dtype=x.dtype, device=x.device)
        x_nhwc = torch.empty((n, h, w, nhwc_channels(c, x.dtype)), dtype=x.dtype,
                             device=x.device)
        code = lib.dafne_deform_im2col(x.data_ptr(), offsets.data_ptr(), _ptr(mask),
                                       cols.data_ptr(), x_nhwc.data_ptr(), n, c, h, w,
                                       DTYPE_CODES[x.dtype],
                                       torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"deform_im2col_forward_cuda: CUDA launch failed with cudaError {code}")
    deform_im2col_forward_cuda.launches += 1
    return cols


def deform_im2col_backward_cuda(x: torch.Tensor, offsets: torch.Tensor,
                                mask: Optional[torch.Tensor], grad_cols: torch.Tensor):
    """(grad x in x's dtype, grad offsets f32, grad mask in x's dtype or
    None) of the columns' gradient grad_cols [N, 9C, H, W] (x's dtype)."""
    n, c, h, w = _check(x, offsets, mask)
    check_cuda("grad_cols", grad_cols, x.dtype, (n, 9 * c, h, w))
    lib = _lib()
    with torch.cuda.device(x.device):
        gx = torch.zeros((n, c, h, w), dtype=torch.float32, device=x.device)
        goff = torch.empty((n, 18, h, w), dtype=torch.float32, device=x.device)
        gmask = (None if mask is None else
                 torch.empty((n, 9, h, w), dtype=torch.float32, device=x.device))
        code = lib.dafne_deform_im2col_backward(
            x.data_ptr(), offsets.data_ptr(), _ptr(mask), grad_cols.data_ptr(), gx.data_ptr(),
            goff.data_ptr(), _ptr(gmask), n, c, h, w, DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"deform_im2col_backward_cuda: CUDA launch failed with cudaError {code}")
    deform_im2col_backward_cuda.launches += 1
    return gx.to(x.dtype), goff, None if gmask is None else gmask.to(mask.dtype)


deform_im2col_forward_cuda.launches = 0
deform_im2col_backward_cuda.launches = 0


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


def reset_launch_counts() -> None:
    deform_im2col_forward_cuda.launches = 0
    deform_im2col_backward_cuda.launches = 0
