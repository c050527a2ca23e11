"""Target-assignment argmin: the min-area gt of every location (K3).

Counterpart of ``dafne_tpu/ops/pallas/assign.py`` (``_assign_kernel``,
reached through ``assign_argmin``), batched over images.  As in
``quad_nms.py`` there are
  - a CUDA kernel (``dafne_torch/csrc/assign.cu``) behind a wrapper that
    checks its inputs, launches on the current stream, raises on a launch
    error and counts its launches (``assign_argmin_cuda.launches``);
  - a plain PyTorch version (``assign_argmin_plain``) that restates the
    Pallas kernel op for op, chunked over gts; it is what runs on the CPU,
    and on the card it is the kernel's reference;
  - a dispatcher (``assign_argmin``): the kernel for CUDA tensors, the
    plain version for CPU tensors.  A CUDA tensor launches the kernel or
    raises.

The kernel assigns each block of ``BLOCK`` consecutive locations over the
gts its block lists: under the flags where a pair needs ``in_center`` to
win (``culls``), only those whose clipped center box meets the block's
box and, with the level filter, whose hbox reaches the block's lowest
size range.  ``gt_lists`` is the plain form of that cull, ``assign_argmin_listed``
the plain form of assigning over the lists (equal to
``assign_argmin_plain``, since the cull drops only pairs whose value is
INF) and ``pair_counts`` the pairs each form evaluates.

The point-in-quad test sums the four triangle areas in the Pallas kernel's
order, which is not ``geometry.quads.is_in_quadrilateral``'s.  The two
orders round differently, so on a few exactly-boundary locations (under
0.1%) the result differs from the JAX package's XLA scan.  Against the
Pallas kernel in interpret mode it is exact up to XLA's choice to contract
a product into an FMA on the CPU, which can flip such a location too; the
CUDA kernel is built without FMA contraction and is bit-equal to it.
"""

from __future__ import annotations

import ctypes

import torch

from dafne_torch.ops.kernels.build import check_cuda, load
from dafne_torch.utils.measure import F32_FLOPS, F32_OPS_NO_FMA, bound

INF = 100000000.0
EPS = 1e-3  # the in-quad tolerance of the reference (dafne_outputs.py:109-119)
GT_CHUNK = 32  # gts per step of the plain version: memory is [B, K, GT_CHUNK]
BLOCK = 128  # consecutive locations per block of the kernel (kThreads in assign.cu)

#: f32 operations that one (location, valid gt) pair needs with the recipe's
#: flags (center sampling combined with point-in-quad, in-box check, level
#: filter), each add, sub, mul, min/max and compare counted as 1 and abs as
#: a free source modifier.  Not counted: terms of one gt or one location
#: alone (the gt's center, area + eps, the location's radius), and selects.
#: ltrb 4 sub and max_ltrb 3 max (7); the center box 4 add/sub and 4 clamps,
#: the point's offsets to it 4 sub, their minimum 3 and the compare 1 (16);
#: point-in-quad: the 4 corners' offsets from the point 8 sub, per edge a
#: cross product (2 mul, 1 sub), the half (1 mul) and the running sum
#: (1 add), then 1 compare (29); the level filter 2 compares and the
#: running minimum 1 (3).
OPS_PER_PAIR = 55


def _center_sample_mask(x, y, st, hb, radius: float):
    """Center sampling (dafne_tpu/ops/targets.py::_center_sample_mask,
    dafne_outputs.py:297-352): inside the box center +- radius * stride,
    clamped to the gt's hbox.  x, y, st [1, K, 1]; hb [B, 1, C, 4] ->
    [B, K, C] bool."""
    cx = 0.5 * (hb[..., 0] + hb[..., 2])
    cy = 0.5 * (hb[..., 1] + hb[..., 3])
    rad = st * radius
    xmin = torch.maximum(cx - rad, hb[..., 0])
    ymin = torch.maximum(cy - rad, hb[..., 1])
    xmax = torch.minimum(cx + rad, hb[..., 2])
    ymax = torch.minimum(cy + rad, hb[..., 3])
    return torch.minimum(torch.minimum(x - xmin, xmax - x), torch.minimum(y - ymin, ymax - y)) > 0


def _in_center(x, y, st, hb, spec):
    """[B, K, C] bool: center sampling, or strictly inside the hbox without
    it.  x, y, st [1, K, 1]; hb [B, 1, C, 4]."""
    if spec.center_sample:
        return _center_sample_mask(x, y, st, hb, spec.pos_radius)
    l, t = x - hb[..., 0], y - hb[..., 1]
    r, bt = hb[..., 2] - x, hb[..., 3] - y
    return torch.minimum(torch.minimum(l, r), torch.minimum(t, bt)) > 0


def assign_argmin_plain(locations, loc_strides, size_ranges, gt_corners, gt_hbox,
                        gt_area, gt_valid, spec):
    """(min_area [B, K] f32, argmin [B, K] i32), the Pallas kernel restated.

    locations [K, 2], loc_strides [K], size_ranges [K, 2] (shared by the
    images); gt_corners [B, M, 8], gt_hbox [B, M, 4], gt_area [B, M] f32,
    gt_valid [B, M] bool.  Gts go GT_CHUNK at a time; within a chunk the
    first index at the minimum wins, across chunks a strict < keeps the
    earlier one, so the result is the first index at the global minimum
    (0 when every value is INF)."""
    b, m = gt_area.shape
    k = locations.shape[0]
    dev = locations.device
    x = locations[None, :, 0, None]  # [1, K, 1]
    y = locations[None, :, 1, None]
    st = loc_strides[None, :, None]
    lo = size_ranges[None, :, 0, None]
    hi = size_ranges[None, :, 1, None]
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    best = torch.full((b, k), INF, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for c0 in range(0, m, GT_CHUNK):
        c1 = min(c0 + GT_CHUNK, m)
        hb = gt_hbox[:, None, c0:c1, :]  # [B, 1, C, 4]
        l = x - hb[..., 0]
        t = y - hb[..., 1]
        r = hb[..., 2] - x
        bt = hb[..., 3] - y
        max_ltrb = torch.maximum(torch.maximum(l, r), torch.maximum(t, bt))
        in_center = _in_center(x, y, st, hb, spec)
        if spec.center_sample_only:
            is_in = in_center
        else:
            cor = gt_corners[:, None, c0:c1, :]  # [B, 1, C, 8]
            tri_sum = torch.zeros_like(l)
            for q in range(4):
                q1 = (q + 1) % 4
                ax, ay = cor[..., 2 * q], cor[..., 2 * q + 1]
                bx, by = cor[..., 2 * q1], cor[..., 2 * q1 + 1]
                tri_sum = tri_sum + 0.5 * ((ax - x) * (by - y) - (ay - y) * (bx - x)).abs()
            in_quad = ~(tri_sum > (gt_area[:, None, c0:c1] + EPS))
            is_in = (in_center & in_quad) if spec.combine_center_sample else in_quad
        area = gt_area[:, None, c0:c1].expand_as(l)
        val = torch.where(gt_valid[:, None, c0:c1], area, inf)
        if spec.enable_in_box_check:
            val = torch.where(is_in, val, inf)
        if spec.enable_level_size_filtering:
            val = torch.where((max_ltrb >= lo) & (max_ltrb <= hi), val, inf)
        c_min = val.amin(-1)
        col = torch.arange(c0, c1, dtype=torch.int32, device=dev)
        c_arg = torch.where(val == c_min[..., None], col, 2**30).amin(-1)
        update = c_min < best
        best = torch.where(update, c_min, best)
        best_idx = torch.where(update, c_arg, best_idx)
    return best, best_idx


def culls(spec) -> bool:
    """Whether the kernel culls gts per block under `spec`'s flags: only
    where a pair's value is INF unless in_center holds (the in-box check on,
    with CENTER_SAMPLE_ONLY or COMBINE_CENTER_SAMPLE)."""
    return spec.enable_in_box_check and (spec.center_sample_only or spec.combine_center_sample)


def gt_lists(locations, loc_strides, size_ranges, gt_hbox, gt_valid, spec,
             block: int = BLOCK):
    """[B, ceil(K / block), M] bool: the gts that each block of `block`
    consecutive locations lists, the kernel's cull in plain PyTorch.

    A gt is listed when it is valid and, where ``culls(spec)``, its hbox
    clipped to its center +- the block's largest stride x radius (the
    center-sampling box, formed with the same f32 expressions; the hbox
    itself without center sampling) meets the bounding box of the block's
    locations strictly and, with the level filter on, the hbox's larger
    side is not below the block's lowest size range (inside the hbox a
    location's max-ltrb is at most that side).  Elsewhere every valid gt is
    listed."""
    b, m = gt_valid.shape
    k = locations.shape[0]
    nb = -(-k // block)
    inf = float("inf")

    def per_block(v, fill, reduce):  # [K] -> [1, nb, 1], the tail padded with `fill`
        v = torch.nn.functional.pad(v, (0, nb * block - k), value=fill).view(nb, block)
        return reduce(v, 1)[None, :, None]

    x, y = locations[:, 0], locations[:, 1]
    x_lo, x_hi = per_block(x, inf, torch.amin), per_block(x, -inf, torch.amax)
    y_lo, y_hi = per_block(y, inf, torch.amin), per_block(y, -inf, torch.amax)
    lists = gt_valid[:, None, :].expand(b, nb, m)
    if not culls(spec):
        return lists.clone()
    hb = gt_hbox[:, None, :, :]  # [B, 1, M, 4]
    xmin, ymin, xmax, ymax = hb.unbind(-1)
    if spec.center_sample:
        rad_hi = per_block(loc_strides * spec.pos_radius, -inf, torch.amax)
        cx = 0.5 * (xmin + xmax)
        cy = 0.5 * (ymin + ymax)
        xmin, ymin = torch.maximum(cx - rad_hi, xmin), torch.maximum(cy - rad_hi, ymin)
        xmax, ymax = torch.minimum(cx + rad_hi, xmax), torch.minimum(cy + rad_hi, ymax)
    misses = (xmin >= x_hi) | (xmax <= x_lo) | (ymin >= y_hi) | (ymax <= y_lo)
    if spec.enable_level_size_filtering:
        lo_min = per_block(size_ranges[:, 0], inf, torch.amin)
        extent = torch.maximum(hb[..., 2] - hb[..., 0], hb[..., 3] - hb[..., 1])
        misses = misses | (extent < lo_min)
    return lists & ~misses


def assign_argmin_listed(locations, loc_strides, size_ranges, gt_corners, gt_hbox, gt_area,
                         gt_valid, spec, block: int = BLOCK):
    """The kernel's design in plain PyTorch: each block of `block`
    locations assigns over the gts of its list (``gt_lists``) alone, in
    ascending index.  Shapes and result as assign_argmin_plain, to which it
    is equal: an unlisted gt's value is INF at every location of its block."""
    lists = gt_lists(locations, loc_strides, size_ranges, gt_hbox, gt_valid, spec, block)
    outs = [assign_argmin_plain(locations[k0:k0 + block], loc_strides[k0:k0 + block],
                                size_ranges[k0:k0 + block], gt_corners, gt_hbox, gt_area,
                                lists[:, i], spec)
            for i, k0 in enumerate(range(0, locations.shape[0], block))]
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)


def pair_counts(locations, loc_strides, size_ranges, gt_hbox, gt_valid, spec,
                block: int = BLOCK):
    """{"valid", "listed", "candidate"}: the (location, valid gt) pairs of
    the batch; those the kernel runs its pair body on, each block's live
    locations times its listed gts; and, where ``culls(spec)``, those whose
    location passes in_center at its own stride and, with the level filter
    on, whose max-ltrb lies in the location's size range: the pairs whose
    value can be finite, of which only the point-in-quad test remains to
    decide (every valid pair elsewhere)."""
    m = gt_valid.shape[1]
    k = locations.shape[0]
    lists = gt_lists(locations, loc_strides, size_ranges, gt_hbox, gt_valid, spec, block)
    live = torch.full((lists.shape[1],), block, dtype=torch.int64, device=locations.device)
    live[-1] = k - (lists.shape[1] - 1) * block
    counts = {"valid": k * int(gt_valid.sum()), "listed": int((lists.sum(2) * live).sum())}
    if not culls(spec):
        return {**counts, "candidate": counts["valid"]}
    x, y = locations[None, :, 0, None], locations[None, :, 1, None]
    st = loc_strides[None, :, None]
    lo, hi = size_ranges[None, :, 0, None], size_ranges[None, :, 1, None]
    candidate = 0
    for c0 in range(0, m, GT_CHUNK):
        hb = gt_hbox[:, None, c0:c0 + GT_CHUNK, :]
        finite = _in_center(x, y, st, hb, spec) & gt_valid[:, None, c0:c0 + GT_CHUNK]
        if spec.enable_level_size_filtering:
            max_ltrb = torch.maximum(torch.maximum(x - hb[..., 0], hb[..., 2] - x),
                                     torch.maximum(y - hb[..., 1], hb[..., 3] - y))
            finite = finite & (max_ltrb >= lo) & (max_ltrb <= hi)
        candidate += int(finite.sum())
    return {**counts, "candidate": candidate}


def assign_bytes(k: int, b: int, m: int) -> int:
    """K3's bytes, each input read once and each output written once: 20
    per location for its point, stride and size range, 53 per gt slot
    (corners, hbox, area, class, valid), 8 per location and image written
    (min_area and argmin)."""
    return k * 20 + b * m * 53 + b * k * 8


def assign_bound(pairs, k: int, b: int, m: int):
    """((bound ms, bound_by), ops ms over every valid pair, ops bound ms
    without FMA) of K3 with the pair counts `pairs` (``pair_counts``): the
    larger of the f32 work these inputs need (OPS_PER_PAIR for every
    candidate pair: a location inside the gt's clipped center box with its
    max-ltrb in its size range, where only the point-in-quad test is left
    to decide whether the value is finite) over F32_FLOPS and
    ``assign_bytes`` over the card's memory rate.  The second item is the
    bound of earlier runs, OPS_PER_PAIR for every (location, valid gt)
    pair: a kernel that culls gts no longer does that work."""
    return (bound(pairs["candidate"] * OPS_PER_PAIR, F32_FLOPS, assign_bytes(k, b, m)),
            pairs["valid"] * OPS_PER_PAIR / F32_FLOPS * 1e3,
            pairs["candidate"] * OPS_PER_PAIR / F32_OPS_NO_FMA * 1e3)


def _lib():
    lib = load("assign")
    if not getattr(lib, "_dafne_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dafne_assign_argmin.argtypes = [p] * 9 + [i, i, i, f, f, i, p]
        lib.dafne_assign_argmin.restype = i
        lib._dafne_typed = True
    return lib


def _flags(spec) -> int:
    return (int(spec.center_sample) | int(spec.center_sample_only) << 1
            | int(spec.combine_center_sample) << 2 | int(spec.enable_in_box_check) << 3
            | int(spec.enable_level_size_filtering) << 4)


def assign_argmin_cuda(locations, loc_strides, size_ranges, gt_corners, gt_hbox,
                       gt_area, gt_valid, spec):
    """Launch the assignment kernel once for the whole batch (shapes and
    result as assign_argmin_plain; every tensor on one CUDA device)."""
    b, m = gt_area.shape
    k = locations.shape[0]
    if b < 1 or m < 1 or k < 1:
        raise ValueError(f"assign_argmin_cuda: need B, M, K >= 1, got {b}, {m}, {k}")
    check_cuda("locations", locations, torch.float32, (k, 2))
    check_cuda("loc_strides", loc_strides, torch.float32, (k,))
    check_cuda("size_ranges", size_ranges, torch.float32, (k, 2))
    check_cuda("gt_corners", gt_corners, torch.float32, (b, m, 8))
    check_cuda("gt_hbox", gt_hbox, torch.float32, (b, m, 4))
    check_cuda("gt_area", gt_area, torch.float32, (b, m))
    check_cuda("gt_valid", gt_valid, torch.bool, (b, m))
    tensors = (locations, loc_strides, size_ranges, gt_corners, gt_hbox, gt_area, gt_valid)
    if any(t.device != locations.device for t in tensors):
        raise ValueError("assign_argmin_cuda: inputs on different devices")
    lib = _lib()
    with torch.cuda.device(locations.device):
        min_area = torch.empty((b, k), dtype=torch.float32, device=locations.device)
        argmin = torch.empty((b, k), dtype=torch.int32, device=locations.device)
        code = lib.dafne_assign_argmin(
            *(t.data_ptr() for t in tensors), min_area.data_ptr(), argmin.data_ptr(),
            b, k, m, float(spec.pos_radius), EPS, _flags(spec),
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"assign_argmin_cuda: CUDA launch failed with cudaError {code}")
    assign_argmin_cuda.launches += 1
    return min_area, argmin


assign_argmin_cuda.launches = 0


def assign_argmin(locations, loc_strides, size_ranges, gt_corners, gt_hbox, gt_area,
                  gt_valid, spec):
    """(min_area [B, K], argmin [B, K]): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if locations.is_cuda:
        return assign_argmin_cuda(locations, loc_strides, size_ranges, gt_corners, gt_hbox,
                                  gt_area, gt_valid, spec)
    if locations.device.type == "cpu":
        return assign_argmin_plain(locations, loc_strides, size_ranges, gt_corners, gt_hbox,
                                   gt_area, gt_valid, spec)
    raise ValueError(f"assign_argmin: unsupported device {locations.device}")


def reset_launch_counts() -> None:
    assign_argmin_cuda.launches = 0
