"""The kernels of the eval path as ``torch.library`` custom ops (``dafne::``).

Each op has three implementations, and the dispatcher's device key picks
one:

  - CUDA: the hand-written kernel's launcher (its input checks, its launch
    counter, its raise on a bad launch code);
  - CPU: the kernel's plain PyTorch version;
  - fake: the output's shape and dtype alone, for ``torch.export`` and
    other tracing.  It reads no data; the kernels' shape rules (N % TILE,
    greedy's N <= 48 Ki) stay in the real implementations.

No other device has an implementation, so nothing falls back: a CUDA
tensor launches the kernel or raises.  The public functions
(``quad_nms.suppression_bits``, ``suppression_bits_2d``,
``greedy_keep_bits``, ``layers/deform_conv.py::deform_im2col``) call these
ops, so the live path and a program exported by
``tools/export_model.py`` run the same op, and the launch counters count
in both.  Importing ``dafne_torch.ops.kernels`` registers them; a process
that loads an exported program imports this module first.

  dafne::suppression_bits     K1, the strip kernel (class-major candidates)
  dafne::suppression_bits_2d  K2, the 2-D tiled kernel (any score order)
  dafne::greedy_keep_bits     the greedy keep-set over S's bit rows
  dafne::deform_im2col        the deformable sampler's forward, with
                              ``register_autograd`` through
  dafne::deform_im2col_backward  its backward: the CUDA kernel, or on the
                              CPU the plain version's own autograd
  dafne::quantize_act         int8 eval: an activation's int8 NHWC copy and
                              its per-image scales (``quant.py``)
  dafne::int8_conv            int8 eval: the implicit-GEMM s8 conv with its
                              dequantize (``quant.py``)

K3 (``assign.py``) is on the train path only and stays a direct call.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import torch
from torch import Tensor

from dafne_torch.ops.kernels import deform_conv as D
from dafne_torch.ops.kernels import quad_nms as Q
from dafne_torch.ops.kernels import quant as QT


def _bits_fake(corners, classes, iou_threshold, eps):
    b, n = classes.shape
    return corners.new_empty((b, n, n // 32), dtype=torch.int32)


# ---- K1 ----------------------------------------------------------------------

@torch.library.custom_op("dafne::suppression_bits", mutates_args=(), device_types="cpu")
def suppression_bits(corners: Tensor, classes: Tensor, iou_threshold: float,
                     eps: float) -> Tensor:
    """S of class-major candidates as bit rows [B, N, N / 32] int32."""
    return Q.pack_suppression_bits(Q.suppression_matrix_plain(corners, classes, iou_threshold, eps))


@suppression_bits.register_kernel("cuda")
def _(corners, classes, iou_threshold, eps):
    return Q.suppression_bits_cuda(corners, classes, iou_threshold, eps)


suppression_bits.register_fake(_bits_fake)


# ---- K2 ----------------------------------------------------------------------

@torch.library.custom_op("dafne::suppression_bits_2d", mutates_args=(), device_types="cpu")
def suppression_bits_2d(corners: Tensor, classes: Tensor, iou_threshold: float,
                        eps: float) -> Tensor:
    """S of candidates in any score order as bit rows [B, N, N / 32] int32."""
    return Q.pack_suppression_bits(Q.suppression_matrix_plain(corners, classes, iou_threshold, eps))


@suppression_bits_2d.register_kernel("cuda")
def _(corners, classes, iou_threshold, eps):
    return Q.suppression_bits_2d_cuda(corners, classes, iou_threshold, eps)


suppression_bits_2d.register_fake(_bits_fake)


# ---- greedy ------------------------------------------------------------------

@torch.library.custom_op("dafne::greedy_keep_bits", mutates_args=(), device_types="cpu")
def greedy_keep_bits(bits: Tensor, keep_init: Tensor) -> Tensor:
    """keep [B, N] bool: the greedy walk over S's bit rows [B, N, N / 32]."""
    return Q.greedy_keep_plain(Q.unpack_suppression_bits(bits), keep_init)


@greedy_keep_bits.register_kernel("cuda")
def _(bits, keep_init):
    return Q.greedy_keep_bits_cuda(bits, keep_init)


@greedy_keep_bits.register_fake
def _(bits, keep_init):
    return keep_init.new_empty(keep_init.shape, dtype=torch.bool)


# ---- the deformable sampler --------------------------------------------------

@torch.library.custom_op("dafne::deform_im2col", mutates_args=(), device_types="cpu")
def deform_im2col(x: Tensor, offsets: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Columns [N, 9C, H, W] in x's dtype of x [N, C, H, W] sampled at the
    3x3 grid moved by offsets [N, 18, H, W] (read as float32), each tap
    times mask [N, 9, H, W] (x's dtype) when given."""
    return D.deform_im2col_plain(x, offsets, mask)


def _contiguous(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t.contiguous()


@deform_im2col.register_kernel("cuda")
def _(x, offsets, mask):
    return D.deform_im2col_forward_cuda(x.contiguous(), offsets.float().contiguous(),
                                        _contiguous(mask))


@deform_im2col.register_fake
def _(x, offsets, mask):
    n, c, h, w = x.shape
    return x.new_empty((n, 9 * c, h, w))


@torch.library.custom_op("dafne::deform_im2col_backward", mutates_args=(), device_types="cpu")
def deform_im2col_backward(x: Tensor, offsets: Tensor, mask: Optional[Tensor],
                           grad_cols: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(grad x in x's dtype, grad offsets float32, grad mask in the mask's
    dtype, or an empty tensor without a mask) of the columns' gradient
    grad_cols [N, 9C, H, W]: the plain version's own autograd.

    A kernel runs beneath the autograd key, where nothing records a graph,
    so the plain version runs again on a thread of its own: a new thread's
    dispatch state is the default one, with autograd on."""
    def vjp():
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (x, offsets.float()) + (() if mask is None else (mask,))]
            return torch.autograd.grad(D.deform_im2col_plain(*leaves), leaves, grad_cols)

    with ThreadPoolExecutor(1) as pool:
        grads = pool.submit(vjp).result()
    return grads[0], grads[1], grads[2] if mask is not None else x.new_empty(0)


@deform_im2col_backward.register_kernel("cuda")
def _(x, offsets, mask, grad_cols):
    gx, goff, gmask = D.deform_im2col_backward_cuda(
        x.contiguous(), offsets.float().contiguous(), _contiguous(mask), grad_cols.contiguous())
    return gx, goff, gmask if mask is not None else x.new_empty(0)


@deform_im2col_backward.register_fake
def _(x, offsets, mask, grad_cols):
    return (torch.empty_like(x), offsets.new_empty(offsets.shape, dtype=torch.float32),
            torch.empty_like(mask) if mask is not None else x.new_empty(0))


def _deform_setup(ctx, inputs, output):
    x, offsets, mask = inputs
    ctx.save_for_backward(x, offsets, mask)


def _deform_backward(ctx, grad_cols):
    x, offsets, mask = ctx.saved_tensors
    gx, goff, gmask = torch.ops.dafne.deform_im2col_backward(x, offsets, mask, grad_cols)
    return gx, goff.to(offsets.dtype), gmask if mask is not None else None


deform_im2col.register_autograd(_deform_backward, setup_context=_deform_setup)


# ---- int8 eval ---------------------------------------------------------------

@torch.library.custom_op("dafne::quantize_act", mutates_args=(), device_types="cpu")
def quantize_act(x: Tensor, static_scale: float) -> Tuple[Tensor, Tensor]:
    """(x_q [N, H, W, C] int8, scale [N] f32) of x [N, C, H, W]: per-image
    dynamic scales when `static_scale` <= 0, else that scale."""
    return QT.quantize_act_plain(x, static_scale)


@quantize_act.register_kernel("cuda")
def _(x, static_scale):
    return QT.quantize_act_cuda(x.contiguous(), static_scale)


@quantize_act.register_fake
def _(x, static_scale):
    n, c, h, w = x.shape
    return x.new_empty((n, h, w, c), dtype=torch.int8), x.new_empty((n,), dtype=torch.float32)


@torch.library.custom_op("dafne::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv(xq: Tensor, xs: Tensor, wq: Tensor, ws: Tensor, bias: Optional[Tensor],
              stride: List[int], padding: List[int], dilation: List[int],
              out_dtype: torch.dtype) -> Tensor:
    """y [N, O, Ho, Wo] in `out_dtype` of x_q [N, H, W, C] int8 (scales
    [N]) and w_q [O, KH, KW, C] int8 (scales [O]), plus bias [O] f32."""
    return QT.int8_conv_plain(xq, xs, wq, ws, bias, stride, padding, dilation, out_dtype)


@int8_conv.register_kernel("cuda")
def _(xq, xs, wq, ws, bias, stride, padding, dilation, out_dtype):
    return QT.int8_conv_cuda(xq.contiguous(), xs.contiguous(), wq.contiguous(), ws.contiguous(),
                             _contiguous(bias), stride, padding, dilation, out_dtype)


@int8_conv.register_fake
def _(xq, xs, wq, ws, bias, stride, padding, dilation, out_dtype):
    n, h, w, _ = xq.shape
    o, kh, kw = wq.shape[:3]
    ho, wo = QT.conv_out_hw(h, w, kh, kw, stride, padding, dilation)
    return xq.new_empty((n, o, ho, wo), dtype=out_dtype)
