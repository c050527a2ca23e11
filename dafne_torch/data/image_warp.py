"""Bilinear resize and affine warp of uint8 images, byte for byte as cv2.

Counterpart of the two cv2 calls of ``dafne_tpu/data/transforms.py``
(``AffineAug.apply_image``, :61-130): ``cv2.resize(img, (W, H),
interpolation=cv2.INTER_LINEAR)`` and ``cv2.warpAffine(img, A, (W, H),
flags=cv2.INTER_LINEAR)`` (BORDER_CONSTANT, value 0) on [H, W, C] uint8.

- ``resize_linear`` and ``warp_affine_linear`` run the host library
  ``csrc/image_warp.cpp`` (built with g++ at first use, through
  ``ops/kernels/build.py``) and count their calls in ``.launches``.  A
  failed build raises; nothing falls back to the plain versions.
- ``resize_linear_plain`` and ``warp_affine_linear_plain`` spell OpenCV's
  arithmetic out step by step in NumPy: the plain versions the tests and
  the card's smoke check hold the library against.

The resize is OpenCV's fixed point: 11-bit weights, a horizontal pass into
int rows, and a vertical pass rounded as ``((b0 * (r0 >> 4)) >> 16) +
((b1 * (r1 >> 4)) >> 16) + 2 >> 2``.  The warp is OpenCV 5's float32
kernel: the float32 forward matrix widened to double and inverted there,
cast to float, source coordinates by fused multiply-adds (16 pixels at a
time as its AVX2 loop maps them, the rest of a row as its scalar tail),
and the four taps (0 outside the source) blended by three fused
multiply-adds and rounded to even.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_COUNT_LOCK = threading.Lock()  # the loader's threads warp at once
WARP_LANES = 16  # pixels per iteration of OpenCV's AVX2 warp loop
COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE


def reset_launch_counts() -> None:
    _RESIZE.launches = 0
    _WARP.launches = 0


def _lib():
    from dafne_torch.ops.kernels import build

    lib = build.load("image_warp")
    if not getattr(lib, "_dafne_typed", False):
        i, p = ctypes.c_int64, ctypes.c_void_p
        lib.resize_linear.argtypes = [p, i, i, i, p, i, i]
        lib.resize_linear.restype = i
        lib.warp_affine_linear.argtypes = [p, i, i, i, p, i, i, p]
        lib.warp_affine_linear.restype = i
        lib._dafne_typed = True
    return lib


def _check(img: np.ndarray, w: int, h: int) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected an [H, W] or [H, W, C] uint8 image, got {img.dtype} "
                         f"{img.shape}")
    if min(img.shape[:2]) < 1 or w < 1 or h < 1:
        raise ValueError(f"empty size: image {img.shape[:2]} to {h}x{w}")
    return np.ascontiguousarray(img)


def _out(img: np.ndarray, w: int, h: int) -> np.ndarray:
    return np.empty((h, w) + img.shape[2:], np.uint8)


def _cn(img: np.ndarray) -> int:
    return img.shape[2] if img.ndim == 3 else 1


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 image, in the host library."""
    img = _check(img, w, h)
    out = _out(img, w, h)
    # ctypes drops the GIL for the call
    _lib().resize_linear(img.ctypes.data, img.shape[0], img.shape[1], _cn(img),
                         out.ctypes.data, h, w)
    with _COUNT_LOCK:
        _RESIZE.launches += 1
    return out


def warp_affine_linear(img: np.ndarray, matrix: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, (w, h), flags=cv2.INTER_LINEAR)`` of a
    uint8 image, `matrix` the [2, 3] forward map (taken as float32, as the
    JAX package passes it), in the host library."""
    img = _check(img, w, h)
    m = np.ascontiguousarray(np.asarray(matrix, np.float32).reshape(2, 3))
    out = _out(img, w, h)
    _lib().warp_affine_linear(img.ctypes.data, img.shape[0], img.shape[1], _cn(img),
                              out.ctypes.data, h, w, m.ctypes.data)
    with _COUNT_LOCK:
        _WARP.launches += 1
    return out


# the counted functions, also while a caller wraps the module's names
_RESIZE, _WARP = resize_linear, warp_affine_linear
reset_launch_counts()


# ---- the plain versions -----------------------------------------------------

def _coefs(n_dst: int, n_src: int):
    """cv::resize's source index and float fraction of each output index."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _coef(w: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(w * 2048) of float32 `w`: rounded half to even."""
    v = np.rint((w * np.float32(COEF_SCALE)).astype(np.float32))
    return np.clip(v, -32768, 32767).astype(np.int64)


def resize_linear_plain(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``resize_linear`` in NumPy."""
    img = _check(img, w, h)
    src = img.reshape(img.shape[0], img.shape[1], -1).astype(np.int64)
    sh, sw = src.shape[:2]
    sx, fx = _coefs(w, sw)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= sw - 1
    fx[high], sx[high] = 0, sw - 1
    a0, a1 = _coef(np.float32(1) - fx), _coef(fx)
    sx1 = np.minimum(sx + 1, sw - 1)  # weight 0 there
    rows = src[:, sx] * a0[None, :, None] + src[:, sx1] * a1[None, :, None]
    sy, fy = _coefs(h, sh)
    b0, b1 = _coef(np.float32(1) - fy), _coef(fy)
    r0 = rows[np.clip(sy, 0, sh - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, sh - 1)] >> 4
    out = (((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((h, w) + img.shape[2:])


def fma_f32(a, b, c) -> np.ndarray:
    """The float32 fused multiply-add a * b + c, rounded once.  The product
    of two float32 is exact in float64; the sum is taken exactly as a
    double and its error (TwoSum), and a double that falls on a float32
    rounding midpoint is broken toward the exact sum."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.float32(np.inf), np.float32(-np.inf)))
    o64 = other.astype(np.float64)
    tie = (s != r64) & (s == (r64 + o64) / 2) & (e != 0)
    return np.where(tie & (np.sign(e) == np.sign(o64 - r64)), other, r)


def _inverse(matrix: np.ndarray):
    """cv::warpAffine's inverse of the float32 forward matrix, in double."""
    m = [float(v) for v in np.asarray(matrix, np.float32).reshape(6)]
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, m[1] * -det, m[3] * -det, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.asarray(m, np.float64).astype(np.float32)


def warp_affine_linear_plain(img: np.ndarray, matrix: np.ndarray, w: int, h: int,
                             rows_per_chunk: int = 256) -> np.ndarray:
    """``warp_affine_linear`` in NumPy, `rows_per_chunk` output rows at a
    time."""
    img = _check(img, w, h)
    src = img.reshape(img.shape[0], img.shape[1], -1)
    sh, sw, cn = src.shape
    M = _inverse(matrix)
    out = np.empty((h, w, cn), np.uint8)
    x = np.arange(w, dtype=np.float32)[None, :]
    vec = (np.arange(w) < w - w % WARP_LANES)[None, :]
    flat = src.reshape(-1, cn).astype(np.float32)
    for y0 in range(0, h, rows_per_chunk):
        y = np.arange(y0, min(h, y0 + rows_per_chunk), dtype=np.float32)[:, None]
        shape = (y.shape[0], w)
        ym1, ym4 = y * M[1], y * M[4]
        sx = np.where(vec, fma_f32(M[0], x, ym1 + M[2]),
                      fma_f32(x, M[0], ym1) + M[2]).astype(np.float32).reshape(shape)
        sy = np.where(vec, fma_f32(M[3], x, ym4 + M[5]),
                      fma_f32(x, M[3], ym4) + M[5]).astype(np.float32).reshape(shape)
        inside = (sx >= -1) & (sx < sw) & (sy >= -1) & (sy < sh)
        flx = np.floor(np.where(inside, sx, 0)).astype(np.float32)
        fly = np.floor(np.where(inside, sy, 0)).astype(np.float32)
        a = (np.where(inside, sx, 0) - flx)[..., None]
        b = (np.where(inside, sy, 0) - fly)[..., None]
        ix, iy = flx.astype(np.int64), fly.astype(np.int64)

        def tap(dy, dx):
            yy, xx = iy + dy, ix + dx
            ok = inside & (xx >= 0) & (xx < sw) & (yy >= 0) & (yy < sh)
            v = flat[np.where(ok, yy * sw + xx, 0)]
            return np.where(ok[..., None], v, np.float32(0))

        p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
        v0 = fma_f32(a, p01 - p00, p00)
        v1 = fma_f32(a, p11 - p10, p10)
        v = fma_f32(b, v1 - v0, v0)
        out[y0:y0 + shape[0]] = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])
