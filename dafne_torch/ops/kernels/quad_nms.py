"""Rotated-quad NMS kernels: the suppression matrix and the greedy keep-set.

Counterpart of ``dafne_tpu/ops/pallas/quad_nms.py``.  The suppression matrix
has two kernels, as there: the strip kernel for class-major candidates (K1,
``class_major=True``) and the 2-D tiled kernel for any score order (K2).
Both write S as bit rows (``pack_suppression_bits``: [B, N, N / 32] int32
words, bit k of word w in row i is S[i, 32 w + k]), and the greedy kernel
walks those.  Each function has
  - a CUDA kernel (``dafne_torch/csrc/quad_nms.cu``) behind a wrapper that
    checks its inputs, launches on the current stream, raises on a launch
    error and counts its launches (``<wrapper>.launches``);
  - a plain PyTorch version of the same function, used for CPU tensors and
    as the kernel's reference on the card;
  - a public function (``suppression_bits``, ``suppression_bits_2d``,
    ``greedy_keep_bits``) that calls its ``torch.ops.dafne`` op
    (``library.py``), whose device key picks the kernel for CUDA tensors
    and the plain version for CPU tensors.  There is no fallback: a CUDA
    tensor launches the kernel or raises, and no other device is taken.
"""

from __future__ import annotations

import ctypes

import torch

from dafne_torch.ops.kernels.build import check_cuda, load
from dafne_torch.utils.measure import (
    F32_FLOPS,
    F32_OPS_NO_FMA,
    HBM_BYTES_PER_S,
    SERIAL_STEP_CYCLES,
    SM_CLOCK_HZ,
    bound,
)

TILE = 128  # column block of K1; NMS pads N to a multiple
STRIP = 64  # rows per strip of K1
TILE_2D = 64  # rows and columns of K2's square tiles (kTile2 in quad_nms.cu)

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


def pack_suppression_bits(s: torch.Tensor) -> torch.Tensor:
    """S [B, N, N] (nonzero = suppresses), N % 32 == 0 -> bit rows [B, N,
    N / 32] int32: bit k of word w in row i is S[i, 32 w + k].

    Packed a byte at a time, so no temporary is wider than S: a word is
    four little-endian bytes (on the card and on the CPUs torch runs on),
    and byte k of word w holds S[i, 32 w + 8 k .. 32 w + 8 k + 7]."""
    b, n, _ = s.shape
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=s.device)
    octets = (s != 0).reshape(b, n, n // 8, 8).to(torch.uint8) * weights
    return octets.sum(-1, dtype=torch.uint8).view(torch.int32)


def unpack_suppression_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bit rows [B, N, N / 32] int32 -> S [B, N, N] int8 (0/1), a byte at
    a time as pack_suppression_bits."""
    b, n, w = bits.shape
    shifts = torch.arange(8, device=bits.device, dtype=torch.uint8)
    s = (bits.contiguous().view(torch.uint8)[..., None] >> shifts) & 1
    return s.view(torch.int8).reshape(b, n, w * 32)


def live_blocks(classes: torch.Tensor, rows: int = STRIP, cols: int = TILE) -> torch.Tensor:
    """[B, N / rows, N / cols] bool: the (rows x cols) blocks of S that the
    suppression kernels compute, those holding a pair j > i whose classes
    are equal and >= 0 (K1's blocks by default; K2's with rows = cols =
    TILE_2D).  Every other block of S is zero, and the kernels write its
    words as zeros without loading a corner."""
    b, n = classes.shape
    col = torch.arange(n, device=classes.device)
    out = torch.empty((b, n // rows, n // cols), dtype=torch.bool, device=classes.device)
    for s in range(n // rows):
        rc = classes[:, s * rows : (s + 1) * rows, None]  # [B, R, 1]
        later = col[None, None, :] > col[s * rows : (s + 1) * rows, None]
        pair = (rc == classes[:, None, :]) & (rc >= 0) & later  # [B, R, N]
        out[:, s] = pair.view(b, rows, n // cols, cols).any(-1).any(1)
    return out


def _lib():
    lib = load("quad_nms")
    if not getattr(lib, "_dafne_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dafne_suppression_bits.argtypes = [p, p, p, i, i, f, f, p]
        lib.dafne_suppression_bits.restype = i
        lib.dafne_suppression_bits_2d.argtypes = [p, p, p, i, i, f, f, p]
        lib.dafne_suppression_bits_2d.restype = i
        lib.dafne_greedy_keep_bits.argtypes = [p, p, p, i, i, p]
        lib.dafne_greedy_keep_bits.restype = i
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


def _launch_bits(entry, what, corners, classes, iou_threshold, eps):
    """Check the inputs, allocate the bit rows uninitialised and launch the
    library's suppression kernel `entry` on them (it writes every word)."""
    b, n = _check_suppression_inputs(what, corners, classes)
    fn = getattr(_lib(), entry)
    with torch.cuda.device(corners.device):
        out = torch.empty((b, n, n // 32), dtype=torch.int32, device=corners.device)
        code = fn(corners.data_ptr(), classes.data_ptr(), out.data_ptr(), b, n,
                  float(iou_threshold), float(eps), torch.cuda.current_stream().cuda_stream)
    _raise_on(code, what)
    return out


def suppression_bits_cuda(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """Launch the strip suppression kernel (K1): corners [B, N, 8] f32 (CCW,
    any order that is score-descending within a class; fast when class-major,
    where most blocks are dead or dense), classes [B, N] i32 (< 0 for
    invalid and padded slots), N % TILE == 0.  Returns S as bit rows
    [B, N, N / 32] int32 (see pack_suppression_bits)."""
    out = _launch_bits("dafne_suppression_bits", "suppression_bits_cuda", corners, classes,
                       iou_threshold, eps)
    suppression_bits_cuda.launches += 1
    return out


suppression_bits_cuda.launches = 0


def suppression_bits(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """S of class-major candidates as bit rows [B, N, N / 32] int32
    (``dafne::suppression_bits``): K1 for CUDA tensors, the packed plain S
    for CPU tensors."""
    return torch.ops.dafne.suppression_bits(corners, classes, float(iou_threshold), float(eps))


def suppression_bits_2d_cuda(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """Launch the 2-D tiled suppression kernel (K2): corners [B, N, 8] f32
    (CCW, any order that is score-descending within a class), classes
    [B, N] i32 (< 0 for invalid and padded slots), N % TILE == 0.  Returns
    S as bit rows [B, N, N / 32] int32, as K1."""
    out = _launch_bits("dafne_suppression_bits_2d", "suppression_bits_2d_cuda", corners,
                       classes, iou_threshold, eps)
    suppression_bits_2d_cuda.launches += 1
    return out


suppression_bits_2d_cuda.launches = 0


def suppression_bits_2d(corners, classes, iou_threshold: float, eps: float = 1e-6):
    """S of candidates in any score order as bit rows [B, N, N / 32] int32
    (``dafne::suppression_bits_2d``): K2 for CUDA tensors, the packed plain
    S for CPU tensors."""
    return torch.ops.dafne.suppression_bits_2d(corners, classes, float(iou_threshold), float(eps))


def suppression_matrix(corners, classes, iou_threshold: float, eps: float = 1e-6,
                       class_major: bool = False):
    """S [B, N, N] int8 (see suppression_matrix_plain): the bit rows of the
    strip kernel's op (K1) when `class_major`, else of the 2-D tiled
    kernel's (K2), unpacked.  NMS takes the bit rows themselves
    (suppression_bits, suppression_bits_2d)."""
    bits = (suppression_bits if class_major else suppression_bits_2d)(corners, classes,
                                                                     iou_threshold, eps)
    return unpack_suppression_bits(bits)


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


_GREEDY_MAX_N = 48 * 1024  # the kernel's `removed` words (N / 8 bytes) in shared memory


def greedy_keep_bits_cuda(bits: torch.Tensor, keep_init: torch.Tensor) -> torch.Tensor:
    """Launch the greedy kernel: bits [B, N, N / 32] int32, keep_init [B, N]
    bool, N % TILE == 0.  Returns keep [B, N] bool."""
    b, n = keep_init.shape
    if n % TILE or not TILE <= n <= _GREEDY_MAX_N or b < 1:
        raise ValueError(f"greedy_keep_bits_cuda: need B >= 1, N % {TILE} == 0 and "
                         f"N <= {_GREEDY_MAX_N}, got {b}x{n}")
    check_cuda("bits", bits, torch.int32, (b, n, n // 32))
    check_cuda("keep_init", keep_init, torch.bool, (b, n))
    if bits.device != keep_init.device:
        raise ValueError("greedy_keep_bits_cuda: bits and keep_init on different devices")
    lib = _lib()
    with torch.cuda.device(bits.device):
        init = keep_init.view(torch.uint8)
        keep = torch.empty((b, n), dtype=torch.uint8, device=bits.device)
        code = lib.dafne_greedy_keep_bits(
            bits.data_ptr(), init.data_ptr(), keep.data_ptr(), b, n,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(code, "greedy_keep_bits_cuda")
    greedy_keep_bits_cuda.launches += 1
    return keep.view(torch.bool)


greedy_keep_bits_cuda.launches = 0


def greedy_keep_bits(bits: torch.Tensor, keep_init: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep-set over the bit rows of S (only bits j > i are
    read; ``dafne::greedy_keep_bits``): the CUDA kernel for CUDA tensors,
    the plain walk over the unpacked S for CPU tensors."""
    return torch.ops.dafne.greedy_keep_bits(bits, keep_init)


# ----------------------------------------------------------------------------
# work counts and bounds
# ----------------------------------------------------------------------------


def same_class_pairs(classes: torch.Tensor) -> int:
    """The pairs j > i of one image with the same valid class (>= 0), summed
    over the batch: the pairs whose IoU K1 and K2 must compute."""
    pairs = 0
    for row in classes.cpu():
        counts = torch.bincount(row[row >= 0].long())
        pairs += int((counts * (counts - 1) // 2).sum())
    return pairs


def suppression_bytes(b: int, n: int) -> int:
    """K1's and K2's bytes for [B, N] candidates: corners and classes read
    once, S written once as bit rows (N^2 / 8 bytes per image)."""
    return b * (n * 8 * 4 + n * 4 + n * n // 8)


def suppression_bound(classes: torch.Tensor, n: int):
    """((bound ms, bound_by), same-class pairs, ops bound ms without FMA,
    {"bits": ms, "int8": ms}) of K1 or K2 on `classes` [B, N]: the larger
    of the f32 work these inputs need (OPS_PER_PAIR for every same-class
    pair j > i) over F32_FLOPS and the bytes (corners and classes read
    once, S written once as bit rows, N^2 / 8 bytes, as K1 and K2 write it)
    over the card's memory rate.  The third item is the work over
    F32_OPS_NO_FMA, the rate the kernels as built can reach; the last, the
    bytes bound of S as bit rows and as int8."""
    pairs = same_class_pairs(classes)
    b = classes.shape[0]
    by_layout = {"bits": suppression_bytes(b, n) / HBM_BYTES_PER_S * 1e3,
                 "int8": b * (n * 8 * 4 + n * 4 + n * n) / HBM_BYTES_PER_S * 1e3}
    return (bound(pairs * OPS_PER_PAIR, F32_FLOPS, suppression_bytes(b, n)), pairs,
            pairs * OPS_PER_PAIR / F32_OPS_NO_FMA * 1e3, by_layout)


def greedy_bytes(keep: torch.Tensor) -> int:
    """The bytes the greedy walk needs for the keep-set `keep` [B, N]: each
    kept row i's upper-triangle words of the bit rows (words i // 32 ..
    N / 32 - 1, 4 bytes each), plus the keep_init read and the keep
    written."""
    n = keep.shape[1]
    idx = torch.nonzero(keep.cpu())[:, 1]
    return int((n // 32 - idx // 32).sum()) * 4 + 2 * keep.numel()


def greedy_bound(keep: torch.Tensor, n: int):
    """((bound ms, "bytes"), int8 bytes ms, serial floor ms) of the greedy
    kernel that returned `keep`.  The bound is ``greedy_bytes`` over the
    card's memory rate (no arithmetic to speak of).  Beside it, the same
    over int8 S (N - 1 - i bytes per kept row), and the serial floor the
    chunked design implies: N / 32 chunks of 32 dependent steps, each at
    least one ALU latency (SERIAL_STEP_CYCLES) at the boost clock."""
    idx = torch.nonzero(keep.cpu())[:, 1]
    int8_bytes = int((n - 1 - idx).sum()) + 2 * keep.numel()
    floor = n // 32 * 32 * SERIAL_STEP_CYCLES / SM_CLOCK_HZ * 1e3
    return ((greedy_bytes(keep) / HBM_BYTES_PER_S * 1e3, "bytes"),
            int8_bytes / HBM_BYTES_PER_S * 1e3, floor)


def reset_launch_counts() -> None:
    suppression_bits_cuda.launches = 0
    suppression_bits_2d_cuda.launches = 0
    greedy_keep_bits_cuda.launches = 0
