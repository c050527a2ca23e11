"""The int8 (w8a8) eval kernels (``quantize_act``, ``int8_conv``) and their
plain versions.

The CUDA kernels of ``dafne_torch/csrc/int8_conv.cu`` behind wrappers that
check their inputs, launch on the current stream, raise on a launch error
and count their launches (``quantize_act_cuda.launches``,
``int8_conv_cuda.launches``), and the plain PyTorch versions
``quantize_act_plain`` and ``int8_conv_plain``.  ``library.py`` joins each
pair into an op, ``dafne::quantize_act`` and ``dafne::int8_conv``;
``layers/quant.py`` holds the model-level logic around them.

No Pallas kernel is replaced: JAX leaves this work to XLA
(``dafne_tpu/layers/quant.py:60-101`` quantizes, ``:112-134`` convolves
int8 with an int32 accumulator and dequantizes).  Both kernels are
bit-equal to their plain versions:

  - quantize: x in f32, per image scale = max(max|x| / 127, 1e-8) (or a
    static scale), x_q = clip(round_half_even(x / scale), -127, 127), the
    divide in f32;
  - conv: an exact s32 sum (the plain version convolves the int8 values in
    float64, exact for |sum| <= 127^2 K < 2^53, with cuDNN off, whose FFT
    and Winograd algorithms would round), then acc.float() * (x_s[n] *
    w_s[o]) (+ bias[o]) in f32 and the cast to the output dtype.

Layouts: x [N, C, H, W] in; x_q [N, H, W, C] int8 (channels innermost,
the GEMM's depth); w_q [O, KH, KW, C] int8, quantized once per eval
program; the conv's output [N, O, Ho, Wo].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dafne_torch.ops.kernels.build import check_cuda, load

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ACT_SCALE_FLOOR = 1e-8  # a zero image stays finite (JAX's _ACT_SCALE_FLOOR)


def act_scale_dynamic(xf: torch.Tensor) -> torch.Tensor:
    """[N] f32 per-image scales max(max|x| / 127, 1e-8) of float32 `xf`
    [N, ...].  The divisor is a tensor: CUDA's division by a Python scalar
    multiplies by its reciprocal, which rounds differently."""
    amax = xf.abs().amax(dim=tuple(range(1, xf.dim())))
    return torch.clamp_min(amax / amax.new_tensor(127.0), ACT_SCALE_FLOOR)


def static_act_scale(amax: float) -> float:
    """The static scale of a calibrated abs-max, as JAX forms it: the
    divide in double, then rounded to float32 where it meets the f32
    activations."""
    return float(torch.tensor(max(float(amax) / 127.0, ACT_SCALE_FLOOR), dtype=torch.float32))


def quantize_with_scale(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 clip(round_half_even(xf / scale), -127, 127); `scale`
    broadcasts against float32 `xf`."""
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_act_plain(x: torch.Tensor, static_scale: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_q [N, H, W, C] int8, scale [N] f32) of x [N, C, H, W]: dynamic
    per-image scales when `static_scale` <= 0, else that scale."""
    xf = x.float()
    if static_scale > 0:
        scale = torch.full((x.shape[0],), static_scale, dtype=torch.float32, device=x.device)
    else:
        scale = act_scale_dynamic(xf)
    return quantize_with_scale(xf, scale[:, None, None, None]).permute(0, 2, 3, 1).contiguous(), scale


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: Sequence[int], padding: Sequence[int],
                dilation: Sequence[int]) -> Tuple[int, int]:
    ho = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    return ho, wo


def int8_conv_plain(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: Sequence[int], padding: Sequence[int],
                    dilation: Sequence[int], out_dtype: torch.dtype) -> torch.Tensor:
    """y [N, O, Ho, Wo] in `out_dtype` of x_q [N, H, W, C] int8 with scales
    x_s [N], w_q [O, KH, KW, C] int8 with scales w_s [O], and bias [O] f32
    or None: the exact s32 sum, then acc * (x_s[n] * w_s[o]) (+ bias) in
    f32."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), None,
                       tuple(stride), tuple(padding), tuple(dilation)).to(torch.int32)
    y = acc.float() * (xs.float()[:, None, None, None] * ws.float()[None, :, None, None])
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(out_dtype)


#: the wgmma kernel's block tile: output pixels, and the channels of one
#: stage (one 128-byte swizzled row of each operand)
WGMMA_TILE_M, WGMMA_TILE_K = 128, 128
#: int8_conv's two kernels: int8_conv_wgmma_kernel and int8_conv_kernel
CONV_PATHS = ("wgmma", "mma_sync")


def int8_conv_path(c: int, stride: Sequence[int]) -> str:
    """The kernel ``int8_conv_cuda`` launches for x_q with `c` channels and
    this stride, by shape: "wgmma" (TMA-fed tiles) where tensor maps can
    describe x_q and w_q, "mma_sync" (the first design) elsewhere.  A
    tensor map needs each dimension's byte stride a multiple of 16 (x_q's
    and w_q's rows are C bytes: C a multiple of 16, so at least 16), and a
    box of at most 256 elements: a run of 128 output pixels at stride s
    spans 128 s input columns, so s is 1 or 2."""
    if c % 16 == 0 and all(s in (1, 2) for s in stride):
        return "wgmma"
    return "mma_sync"


def int8_conv_tiles(n: int, stride: Sequence[int], ho: int, wo: int) -> dict:
    """The wgmma kernel's tile geometry, as the wrapper hands it in.

    A block's pixel tile is `tile` = (bh, bw): bh output rows of bw pixels,
    one contiguous run of the NCHW output plane: a run of 128 pixels of a
    row where Wo >= 128, else bh = 128 // Wo whole rows.  x_q's tensor map
    spans (C, W, H, N), innermost first; one box per (tap, 128-channel
    slice) is `box` elements at `element_strides` (the conv's strides:
    TMA loads ceil(box / stride) elements, bw x bh pixels of 128 channels),
    from the coordinates below; what lies outside the map
    (the zero padding, channels past C) comes as zeros.  The kernel puts
    the box of pixel tile t = (n, th, tw) at tap (r, q) and channel slice
    c0 at (c0, tw bw sw - pw + q dw, th bh sh - ph + r dh, n), negative
    where the padding lies.  w_q's map spans (C, KH*KW, O) in boxes of
    (128, 1, 128)."""
    sh, sw = stride
    bw = min(wo, WGMMA_TILE_M)
    bh = WGMMA_TILE_M // bw if bw == wo else 1
    tiles_h, tiles_w = -(-ho // bh), -(-wo // bw)
    return {"tile": (bh, bw), "box": (WGMMA_TILE_K, bw * sw, bh * sh, 1),
            "element_strides": (1, sw, sh, 1), "tiles_h": tiles_h, "tiles_w": tiles_w,
            "pixel_tiles": n * tiles_h * tiles_w}


def _lib():
    lib = load("int8_conv")
    if not getattr(lib, "_dafne_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dafne_quantize_act.argtypes = [p, i, i, i, i, i, ctypes.c_float, p, p, p, p]
        lib.dafne_quantize_act.restype = i
        lib.dafne_int8_conv.argtypes = [p] * 7 + [i, p]
        lib.dafne_int8_conv.restype = i
        lib._dafne_typed = True
    return lib


def quantize_act_cuda(x: torch.Tensor, static_scale: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_act_plain`` on the card: x contiguous [N, C, H, W] in f32,
    bf16 or f16."""
    if x.dim() != 4 or x.dtype not in DTYPE_CODES or min(x.shape) < 1:
        raise ValueError(f"quantize_act: expected x [N, C, H, W] in {list(DTYPE_CODES)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    n, c, h, w = x.shape
    check_cuda("x", x, x.dtype, (n, c, h, w))
    lib = _lib()
    with torch.cuda.device(x.device):
        xq = torch.empty((n, h, w, c), dtype=torch.int8, device=x.device)
        xs = torch.empty((n,), dtype=torch.float32, device=x.device)
        amax_bits = torch.zeros((n,), dtype=torch.int32, device=x.device)
        code = lib.dafne_quantize_act(x.data_ptr(), n, c, h, w, DTYPE_CODES[x.dtype],
                                      float(static_scale), amax_bits.data_ptr(), xq.data_ptr(),
                                      xs.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"quantize_act_cuda: CUDA launch failed with cudaError {code}")
    quantize_act_cuda.launches += 1
    return xq, xs


def int8_conv_cuda(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: Sequence[int], padding: Sequence[int],
                   dilation: Sequence[int], out_dtype: torch.dtype) -> torch.Tensor:
    """``int8_conv_plain`` on the card: every tensor contiguous on one
    device, x_q [N, H, W, C] and w_q [O, KH, KW, C] int8, the scales and
    the bias f32."""
    if xq.dim() != 4 or wq.dim() != 4 or out_dtype not in DTYPE_CODES:
        raise ValueError(f"int8_conv: expected x_q [N, H, W, C], w_q [O, KH, KW, C] and an "
                         f"output dtype in {list(DTYPE_CODES)}, got {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)}, {out_dtype}")
    n, h, w, c = xq.shape
    o, kh, kw = wq.shape[:3]
    check_cuda("x_q", xq, torch.int8, (n, h, w, c))
    check_cuda("x_s", xs, torch.float32, (n,))
    check_cuda("w_q", wq, torch.int8, (o, kh, kw, c))
    check_cuda("w_s", ws, torch.float32, (o,))
    if bias is not None:
        check_cuda("bias", bias, torch.float32, (o,))
    if len({t.device for t in (xq, xs, wq, ws) + (() if bias is None else (bias,))}) != 1:
        raise ValueError("int8_conv: inputs on different devices")
    ho, wo = conv_out_hw(h, w, kh, kw, stride, padding, dilation)
    if min(n, c, o, ho, wo) < 1:
        raise ValueError(f"int8_conv: empty output {(n, o, ho, wo)} of x_q {tuple(xq.shape)}")
    path = int8_conv_path(c, stride)
    geometry = [n, h, w, c, o, kh, kw, *stride, *padding, *dilation, ho, wo]
    if path == "wgmma":
        for name, t in (("x_q", xq), ("w_q", wq)):
            if t.data_ptr() % 16:
                raise ValueError(f"int8_conv: {name} at {t.data_ptr():#x} is not 16-byte aligned, "
                                 f"as a tensor map needs")
        tiles = int8_conv_tiles(n, stride, ho, wo)
        geometry += [1, *tiles["tile"], *tiles["box"], *tiles["element_strides"]]
    else:
        geometry += [0] * 11
    lib = _lib()
    geometry = (ctypes.c_int * len(geometry))(*geometry)
    with torch.cuda.device(xq.device):
        y = torch.empty((n, o, ho, wo), dtype=out_dtype, device=xq.device)
        code = lib.dafne_int8_conv(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                   None if bias is None else bias.data_ptr(), y.data_ptr(),
                                   ctypes.cast(geometry, ctypes.c_void_p), DTYPE_CODES[out_dtype],
                                   torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"int8_conv_cuda: the {path} kernel's launch failed with code {code} "
                           f"(a cudaError_t; 10000: no cuTensorMapEncodeTiled; 20000 + a "
                           f"CUresult: a tensor map refused)")
    int8_conv_cuda.launches += 1
    int8_conv_cuda.launches_by_path[path] += 1
    return y


quantize_act_cuda.launches = 0
int8_conv_cuda.launches = 0
int8_conv_cuda.launches_by_path = dict.fromkeys(CONV_PATHS, 0)


def reset_launch_counts() -> None:
    quantize_act_cuda.launches = 0
    int8_conv_cuda.launches = 0
    int8_conv_cuda.launches_by_path = dict.fromkeys(CONV_PATHS, 0)


def quantize_bytes(n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """The quantize's bytes, x read once and x_q and the scales written once."""
    return n * c * h * w * (itemsize + 1) + 4 * n


def conv_bytes(n: int, c: int, h: int, w: int, o: int, kh: int, kw: int, ho: int, wo: int,
               out_itemsize: int, bias: bool) -> int:
    """The conv's bytes, each input read once (x_q, w_q, the scales, the
    bias) and y written once."""
    return (n * h * w * c + o * kh * kw * c + 4 * (n + o + (o if bias else 0))
            + n * o * ho * wo * out_itemsize)


def conv_ops(n: int, c: int, o: int, kh: int, kw: int, ho: int, wo: int) -> int:
    """The conv's int8 operations: a multiply and an add per tap, 2 M O K."""
    return 2 * n * ho * wo * o * kh * kw * c
