"""The deformable sampling kernel (``deform_im2col``) on the card.

The CUDA kernels of ``dafne_torch/csrc/deform_conv.cu`` behind wrappers
that check their inputs, launch on the current stream, raise on a launch
error and count their launches (``deform_im2col_forward_cuda.launches``,
``deform_im2col_backward_cuda.launches``), and the
``torch.autograd.Function`` that joins the two (``deform_im2col_cuda``).
The plain PyTorch version and the dispatcher that picks between them by
device are in ``dafne_torch/layers/deform_conv.py``.

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
        lib.dafne_deform_im2col.argtypes = [p] * 4 + [i] * 5 + [p]
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


def deform_im2col_forward_cuda(x: torch.Tensor, offsets: torch.Tensor,
                               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Columns [N, 9C, H, W] in x's dtype (see ``deform_im2col_plain``);
    x contiguous f32/bf16/f16, offsets contiguous f32 [N, 18, H, W], mask
    None or contiguous [N, 9, H, W] in x's dtype, all on one CUDA device."""
    n, c, h, w = _check(x, offsets, mask)
    lib = _lib()
    with torch.cuda.device(x.device):
        cols = torch.empty((n, 9 * c, h, w), dtype=x.dtype, device=x.device)
        code = lib.dafne_deform_im2col(x.data_ptr(), offsets.data_ptr(), _ptr(mask),
                                       cols.data_ptr(), n, c, h, w, DTYPE_CODES[x.dtype],
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


class DeformIm2col(torch.autograd.Function):
    """The kernel's forward and backward as one differentiable op.  Saves
    its inputs, not the columns."""

    @staticmethod
    def forward(ctx, x, offsets, mask):
        x = x.contiguous()
        offsets = offsets.contiguous()
        mask = None if mask is None else mask.contiguous()
        ctx.save_for_backward(x, offsets, mask)
        return deform_im2col_forward_cuda(x, offsets, mask)

    @staticmethod
    def backward(ctx, grad_cols):
        x, offsets, mask = ctx.saved_tensors
        gx, goff, gmask = deform_im2col_backward_cuda(x, offsets, mask, grad_cols.contiguous())
        need = ctx.needs_input_grad
        return (gx if need[0] else None, goff if need[1] else None,
                gmask if mask is not None and need[2] else None)


def deform_im2col_cuda(x: torch.Tensor, offsets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The columns on the card, differentiable in x, offsets and mask."""
    return DeformIm2col.apply(x, offsets, mask)


def reset_launch_counts() -> None:
    deform_im2col_forward_cuda.launches = 0
    deform_im2col_backward_cuda.launches = 0
