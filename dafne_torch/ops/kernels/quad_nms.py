"""Rotated-quad NMS kernels: the suppression matrix and the greedy keep-set.

Counterpart of ``dafne_tpu/ops/pallas/quad_nms.py``.  The suppression matrix
has two kernels, as there: the strip kernel for class-major candidates (K1,
``class_major=True``) and the 2-D tiled kernel for any score order (K2).
Each function has
  - a CUDA kernel (``dafne_torch/csrc/quad_nms.cu``) behind a wrapper that
    checks its inputs, launches on the current stream, raises on a launch
    error and counts its launches (``<wrapper>.launches``);
  - a plain PyTorch version of the same function, used for CPU tensors and
    as the kernel's reference on the card;
  - a dispatcher that launches the kernel for CUDA tensors and takes the
    plain version only for CPU tensors.  There is no fallback: a CUDA
    tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dafne_torch.ops.kernels.build import check_cuda, load

TILE = 128  # column block of the suppression kernel; NMS pads N to a multiple
STRIP = 64  # rows per strip

#: f32 operations that the IoU of one pair needs (add, sub, mul, div,
#: min/max and compares, each counted as 1).  Not counted: terms of one quad
#: alone (edge vectors, areas), which are formed once per quad; abs and neg,
#: which fold into their consumer as source modifiers; selects and predicate
#: logic.  Per clipping half-plane: 2 sub for the offset, 4 mul and 2 sub
#: for num and den, 2 add and 2 mul for their tolerances, 1 div, 5 compares
#: and 1 max or min (19).  An edge of Q adds 2 mul, 1 add and 2 compares for
#: the same-direction test (24).  After the 4 half-planes an edge ends with
#: 13 ops (clipped endpoints, the cross product, t_low < t_high).  So an edge
#: of P costs 89 and an edge of Q 109; with 8 adds into `inter` and 8 ops
#: for the clamp, union and threshold, a pair costs 4 * (89 + 109) + 16.
OPS_PER_PAIR = 808


# ----------------------------------------------------------------------------
# suppression matrix
# ----------------------------------------------------------------------------


def _edge_integral_plain(ax, ay, bx, by, qx, qy, eps, include_boundary):
    """Edge a->b clipped to quad q (lists of 4 coordinates), broadcast.

    The Pallas kernel's `_edge_integral_block`, with the kernel's op order
    (products formed once and reused in the tolerances)."""
    dx = bx - ax
    dy = by - ay
    t_low = torch.zeros_like(ax + qx[0])
    t_high = torch.ones_like(t_low)
    alive = torch.ones_like(t_low, dtype=torch.bool)
    for k in range(4):
        k1 = (k + 1) % 4
        ex = qx[k1] - qx[k]
        ey = qy[k1] - qy[k]
        exry = ex * (ay - qy[k])
        eyrx = ey * (ax - qx[k])
        num = exry - eyrx
        exdy = ex * dy
        eydx = ey * dx
        den = exdy - eydx
        den_tol = eps * (exdy.abs() + eydx.abs())
        num_tol = eps * (exry.abs() + eyrx.abs())
        par = den.abs() <= den_tol
        ratio = -num / torch.where(par, 1.0, den)
        t_low = torch.where(den > den_tol, torch.maximum(t_low, ratio), t_low)
        t_high = torch.where(den < -den_tol, torch.minimum(t_high, ratio), t_high)
        outside = par & (num < -num_tol)
        if not include_boundary:
            same_dir = (ex * dx + ey * dy) > 0
            outside = outside | (par & (num.abs() <= num_tol) & same_dir)
        alive = alive & ~outside
    pax = ax + t_low * dx
    pay = ay + t_low * dy
    pbx = ax + t_high * dx
    pby = ay + t_high * dy
    contrib = 0.5 * (pax * pby - pay * pbx)
    return torch.where(alive & (t_low < t_high), contrib, 0.0)


def _shoelace4(x, y):
    s = x[0] * y[1] - x[1] * y[0]
    for k in range(1, 4):
        s = s + (x[k] * y[(k + 1) % 4] - x[(k + 1) % 4] * y[k])
    return 0.5 * s.abs()


def suppression_matrix_plain(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """Plain PyTorch S [B, N, N] int8, in strips of STRIP rows.

    S[b, i, j] = 1 iff j > i, classes[b, i] == classes[b, j] >= 0 and the
    exact IoU of quads i and j (CCW corners) exceeds `iou_threshold`.  Every
    pair is evaluated, in whatever order the candidates come, so this is the
    plain version of both kernels: the strip kernel (class-major input) and
    the 2-D tiled kernel (any order).  The kernels skip pairs that cannot be
    nonzero."""
    b, n, _ = corners.shape
    qx = [corners[:, None, :, 2 * k] for k in range(4)]  # [B, 1, N]
    qy = [corners[:, None, :, 2 * k + 1] for k in range(4)]
    qa = _shoelace4(qx, qy)
    cc = classes[:, None, :]
    col = torch.arange(n, device=corners.device)
    out = torch.empty((b, n, n), dtype=torch.int8, device=corners.device)
    for r0 in range(0, n, STRIP):
        rows = corners[:, r0 : r0 + STRIP]
        px = [rows[:, :, 2 * k, None] for k in range(4)]  # [B, R, 1]
        py = [rows[:, :, 2 * k + 1, None] for k in range(4)]
        inter = torch.zeros((b, rows.shape[1], n), dtype=corners.dtype, device=corners.device)
        for k in range(4):
            k1 = (k + 1) % 4
            inter = inter + _edge_integral_plain(px[k], py[k], px[k1], py[k1], qx, qy, eps, True)
            inter = inter + _edge_integral_plain(qx[k], qy[k], qx[k1], qy[k1], px, py, eps, False)
        inter = torch.clamp(inter, min=0.0)
        pa = _shoelace4(px, py)
        inter = torch.minimum(inter, torch.minimum(pa, qa))
        union = pa + qa - inter
        iou = torch.where(union == 0.0, (inter + 1.0) / (union + 1.0), inter / union)
        rc = classes[:, r0 : r0 + STRIP, None]
        same = (rc == cc) & (rc >= 0)
        later = col[None, None, :] > (col[r0 : r0 + STRIP])[None, :, None]
        out[:, r0 : r0 + STRIP] = ((iou > iou_threshold) & same & later).to(torch.int8)
    return out


def strip_spans(classes: torch.Tensor) -> torch.Tensor:
    """[B, N / STRIP, 2] int32: each strip's [lo, hi) range of TILE-wide
    column blocks that can hold a nonzero of S.

    Candidates are class-major (ascending class, invalid last), so the
    columns j > i whose class lies in [min, max] of a strip's valid row
    classes form one span; outside it S is zero.  The Pallas strip kernel
    computes the same span in-kernel."""
    b, n = classes.shape
    rc = classes.reshape(b, n // STRIP, STRIP)
    rmin = torch.where(rc >= 0, rc, 2**30).amin(-1, keepdim=True)  # [B, S, 1]
    rmax = torch.where(rc >= 0, rc, -1).amax(-1, keepdim=True)
    ccls = torch.where(classes < 0, -2, classes)[:, None, :]  # [B, 1, N]
    col = torch.arange(n, device=classes.device)
    r0 = (torch.arange(n // STRIP, device=classes.device) * STRIP)[:, None]
    hit = (ccls >= rmin) & (ccls <= rmax) & (col > r0)  # [B, S, N]
    lo = torch.where(hit, col, n).amin(-1)
    hi = torch.where(hit, col, -1).amax(-1) + 1
    return torch.stack([lo // TILE, (hi + TILE - 1) // TILE], -1).to(torch.int32).contiguous()


def tile_interactions(classes: torch.Tensor) -> torch.Tensor:
    """[B, N / TILE, N / TILE] bool: the TILE x TILE tiles of S that the 2-D
    kernel computes, those on or above the diagonal whose row and column
    tiles share a valid class (>= 0); every other tile of S is zero.  The
    Pallas 2-D kernel's interaction test, `(j >= i) & any(rcls == ccls)`."""
    b, n = classes.shape
    t = n // TILE
    c = classes.reshape(b, t, TILE).long()
    n_cls = int(c.max()) + 1 if bool((c >= 0).any()) else 1
    present = torch.zeros((b, t, n_cls + 1), dtype=torch.float32, device=classes.device)
    present.scatter_(2, torch.where(c >= 0, c, n_cls), 1.0)
    present = present[..., :n_cls]
    shared = torch.bmm(present, present.transpose(1, 2)) > 0
    tiles = torch.arange(t, device=classes.device)
    return shared & (tiles[None, None, :] >= tiles[None, :, None])


def _lib():
    lib = load("quad_nms")
    if not getattr(lib, "_dafne_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dafne_suppression_matrix.argtypes = [p, p, p, p, i, i, f, f, p]
        lib.dafne_suppression_matrix.restype = i
        lib.dafne_suppression_matrix_2d.argtypes = [p, p, p, i, i, f, f, p]
        lib.dafne_suppression_matrix_2d.restype = i
        lib.dafne_greedy_keep.argtypes = [p, p, p, i, i, p]
        lib.dafne_greedy_keep.restype = i
        lib._dafne_typed = True
    return lib


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def _check_suppression_inputs(what, corners, classes):
    b, n = classes.shape
    if n % TILE or b < 1:
        raise ValueError(f"{what}: need B >= 1 and N % {TILE} == 0, got {b}x{n}")
    check_cuda("corners", corners, torch.float32, (b, n, 8))
    check_cuda("classes", classes, torch.int32, (b, n))
    if corners.device != classes.device:
        raise ValueError(f"{what}: corners and classes on different devices")
    return b, n


def suppression_matrix_cuda(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """Launch the suppression kernel: corners [B, N, 8] f32 (CCW, class-major,
    score-descending within a class), classes [B, N] i32 (< 0 for invalid
    and padded slots), N % TILE == 0.  Returns S [B, N, N] int8."""
    b, n = _check_suppression_inputs("suppression_matrix_cuda", corners, classes)
    lib = _lib()
    with torch.cuda.device(corners.device):
        spans = strip_spans(classes)
        out = torch.zeros((b, n, n), dtype=torch.int8, device=corners.device)
        code = lib.dafne_suppression_matrix(
            corners.data_ptr(), classes.data_ptr(), spans.data_ptr(), out.data_ptr(),
            b, n, float(iou_threshold), float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "suppression_matrix_cuda")
    suppression_matrix_cuda.launches += 1
    return out


suppression_matrix_cuda.launches = 0


def suppression_matrix_2d_cuda(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """Launch the 2-D tiled suppression kernel: corners [B, N, 8] f32 (CCW,
    any order that is score-descending within a class), classes [B, N] i32
    (< 0 for invalid and padded slots), N % TILE == 0.  Returns S [B, N, N]
    int8."""
    b, n = _check_suppression_inputs("suppression_matrix_2d_cuda", corners, classes)
    lib = _lib()
    with torch.cuda.device(corners.device):
        out = torch.zeros((b, n, n), dtype=torch.int8, device=corners.device)
        code = lib.dafne_suppression_matrix_2d(
            corners.data_ptr(), classes.data_ptr(), out.data_ptr(), b, n,
            float(iou_threshold), float(eps), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "suppression_matrix_2d_cuda")
    suppression_matrix_2d_cuda.launches += 1
    return out


suppression_matrix_2d_cuda.launches = 0


def suppression_matrix(corners, classes, iou_threshold: float, eps: float = 1e-6,
                       class_major: bool = False):
    """S [B, N, N] int8 (see suppression_matrix_plain).  For CUDA tensors a
    kernel: the strip kernel when `class_major` (valid only for class-major
    candidates, invalid last), else the 2-D tiled kernel, which takes any
    score-descending order; for CPU tensors the plain version."""
    if corners.is_cuda:
        kernel = suppression_matrix_cuda if class_major else suppression_matrix_2d_cuda
        return kernel(corners, classes, iou_threshold, eps)
    if corners.device.type == "cpu":
        return suppression_matrix_plain(corners, classes, iou_threshold, eps)
    raise ValueError(f"suppression_matrix: unsupported device {corners.device}")


# ----------------------------------------------------------------------------
# greedy keep-set
# ----------------------------------------------------------------------------


def greedy_keep_plain(s: torch.Tensor, keep_init: torch.Tensor) -> torch.Tensor:
    """Sequential greedy walk: rows in order, a kept row i clears every j > i
    with S[i, j].  s [B, N, N] (nonzero = suppresses), keep_init [B, N] bool.
    Returns keep [B, N] bool."""
    alive = keep_init.clone()
    sup = s != 0
    for i in range(s.shape[1] - 1):
        alive[:, i + 1 :] &= ~(sup[:, i, i + 1 :] & alive[:, i : i + 1])
    return alive


_GREEDY_MAX_N = 48 * 1024  # alive flags live in (static-limit) shared memory


def greedy_keep_cuda(s: torch.Tensor, keep_init: torch.Tensor) -> torch.Tensor:
    """Launch the greedy kernel: s [B, N, N] int8, keep_init [B, N] bool.
    Returns keep [B, N] bool."""
    b, n = keep_init.shape
    if not 1 <= n <= _GREEDY_MAX_N or b < 1:
        raise ValueError(f"greedy_keep_cuda: need B >= 1 and 1 <= N <= {_GREEDY_MAX_N}, got {b}x{n}")
    check_cuda("s", s, torch.int8, (b, n, n))
    check_cuda("keep_init", keep_init, torch.bool, (b, n))
    if s.device != keep_init.device:
        raise ValueError("greedy_keep_cuda: s and keep_init on different devices")
    lib = _lib()
    with torch.cuda.device(s.device):
        init = keep_init.view(torch.uint8)
        keep = torch.empty((b, n), dtype=torch.uint8, device=s.device)
        code = lib.dafne_greedy_keep(
            s.data_ptr(), init.data_ptr(), keep.data_ptr(), b, n,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "greedy_keep_cuda")
    greedy_keep_cuda.launches += 1
    return keep.view(torch.bool)


greedy_keep_cuda.launches = 0


def greedy_keep(s: torch.Tensor, keep_init: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep-set over S: the CUDA kernel for CUDA tensors, the
    plain walk for CPU tensors."""
    if s.is_cuda:
        return greedy_keep_cuda(s, keep_init)
    if s.device.type == "cpu":
        return greedy_keep_plain(s, keep_init)
    raise ValueError(f"greedy_keep: unsupported device {s.device}")


def reset_launch_counts() -> None:
    suppression_matrix_cuda.launches = 0
    suppression_matrix_2d_cuda.launches = 0
    greedy_keep_cuda.launches = 0
