"""Host-side exact polygon IoU in float64 NumPy, vectorized over pairs.

The port's own copy of ``dafne_tpu/utils/polyiou_np.py`` (the evaluator's
polygon IoU), plus the dispatcher names of
``dafne_tpu/utils/polyiou.py`` that the port uses (``iou_poly_pairs``,
``poly_nms``) on this NumPy path; the JAX package's g++ build of
``native/polyiou.cpp`` is not ported.  ``poly_nms`` (the TTA merge) walks
the greedy order a block at a time over IoUs computed in batches, and keeps
exactly what the one-pair-at-a-time loop ``poly_nms_plain`` keeps.

Algorithm: Sutherland-Hodgman clipping of convex polygon P by each
half-plane of convex polygon Q, in float64, an algorithm independent of the
on-device clipped-edge-integral IoU (``geometry/iou.py``, the kernels).
All pairs are processed at once with fixed-size (masked) vertex buffers:
clipping a convex <= K-gon by one line gives a <= K+1-gon, so 4 clips of a
convex quad fit in 8 vertices.  A P that is not convex (a bowtie or a dart,
which a model's raw corners can form) may emit more: such rows clip in a
buffer of 32 vertices whose writes are capped, as ``native/polyiou.cpp``
caps them, instead of overflowing; convex rows give the NumPy reference's
values bit for bit.
"""

from __future__ import annotations

import numpy as np

_MAXV = 9  # 4 vertices + 4 clips; one spare slot for simpler scatter logic
_MAXV_NONCONVEX = 16  # a non-convex P's clips (at most 12 seen), writes capped


def _signed_area(pts, count):
    """Shoelace signed area of masked polygons; pts [N, K, 2], count [N]."""
    n, k, _ = pts.shape
    idx = np.arange(k)[None, :]
    valid = idx < count[:, None]
    nxt_idx = np.where(idx + 1 < count[:, None], idx + 1, 0)
    nxt = np.take_along_axis(pts, nxt_idx[:, :, None], axis=1)
    contrib = pts[:, :, 0] * nxt[:, :, 1] - nxt[:, :, 0] * pts[:, :, 1]
    contrib = np.where(valid, contrib, 0.0)
    return 0.5 * contrib.sum(axis=1)


def _clip_halfplane(pts, count, a, b):
    """Clip masked polygons by half-plane left-of directed line a->b.

    pts: [N, K, 2]; count: [N]; a, b: [N, 2].
    Keeps points p with cross(b - a, p - a) >= 0.
    """
    n, k, _ = pts.shape
    idx = np.arange(k)[None, :]
    valid = idx < count[:, None]

    d = b - a  # [N, 2]
    rel = pts - a[:, None, :]
    side = d[:, None, 0] * rel[:, :, 1] - d[:, None, 1] * rel[:, :, 0]  # [N,K]
    inside = (side >= 0.0) & valid

    nxt_idx = np.where(idx + 1 < count[:, None], idx + 1, 0)
    rows = np.arange(n)[:, None]
    nxt_pts = pts[rows, nxt_idx]
    nxt_side = side[rows, nxt_idx]
    nxt_inside = (nxt_side >= 0.0) & valid

    # Edge crossing point (param t along current->next where side == 0)
    denom = side - nxt_side
    safe = np.where(np.abs(denom) > 0.0, denom, 1.0)
    t = side / safe
    cross_pt = pts + t[:, :, None] * (nxt_pts - pts)
    crossing = (inside != nxt_inside) & valid

    # Each input edge emits: current point (if inside), crossing point (if sign change)
    emit1 = inside
    emit2 = crossing
    counts = emit1.astype(np.int64) + emit2.astype(np.int64)
    pos1 = np.cumsum(counts, axis=1) - counts  # position of first emission
    pos2 = pos1 + emit1.astype(np.int64)
    new_count = counts.sum(axis=1)
    # a polygon that outgrows the buffer keeps its first k - 1 vertices (a
    # convex one never does); the rest would index past the spare slot
    emit1 = emit1 & (pos1 < k - 1)
    emit2 = emit2 & (pos2 < k - 1)

    # Scatter (positions are unique per row by construction); slots past a
    # row's count stay zero
    out = np.zeros((n, k, 2), dtype=pts.dtype)
    r, c = np.nonzero(emit1)
    out[r, pos1[r, c]] = pts[r, c]
    r, c = np.nonzero(emit2)
    out[r, pos2[r, c]] = cross_pt[r, c]
    return out, np.minimum(new_count, k - 1)


def _ensure_ccw(quads):
    """quads [N, 4, 2] -> CCW order."""
    area = _signed_area(quads, np.full(len(quads), 4))
    return np.where(area[:, None, None] < 0.0, quads[:, ::-1, :], quads)


def _convex(quads):
    """[N]: the quads [N, 4, 2] turn one way at every corner (collinear
    corners allowed)."""
    e = np.roll(quads, -1, axis=1) - quads
    f = np.roll(e, -1, axis=1)
    turn = e[:, :, 0] * f[:, :, 1] - e[:, :, 1] * f[:, :, 0]
    return (turn >= 0.0).all(1) | (turn <= 0.0).all(1)


def _clipped_area(p, q, k):
    """|area| of each p [N, 4, 2] clipped by q's 4 half-planes in a k-vertex buffer."""
    pts = np.zeros((len(p), k, 2), dtype=np.float64)
    pts[:, :4] = p
    count = np.full(len(p), 4, dtype=np.int64)
    for e in range(4):
        a = q[:, e]
        b = q[:, (e + 1) % 4]
        pts, count = _clip_halfplane(pts, count, a, b)
    return np.abs(_signed_area(pts, count))


def intersection_area(p, q):
    """Exact intersection areas; p, q: [N, 8] float arrays -> [N]."""
    p = np.asarray(p, dtype=np.float64).reshape(-1, 4, 2)
    q = np.asarray(q, dtype=np.float64).reshape(-1, 4, 2)
    p = _ensure_ccw(p)
    q = _ensure_ccw(q)
    convex = _convex(p)
    if convex.all():
        return _clipped_area(p, q, _MAXV)
    out = np.empty(len(p), dtype=np.float64)
    out[convex] = _clipped_area(p[convex], q[convex], _MAXV)
    out[~convex] = _clipped_area(p[~convex], q[~convex], _MAXV_NONCONVEX)
    return out


def iou_poly(p, q):
    """Exact IoU of two quads (flat [8] sequences), like polyiou.iou_poly."""
    p = np.asarray(p, dtype=np.float64).reshape(1, 8)
    q = np.asarray(q, dtype=np.float64).reshape(1, 8)
    return float(iou_pairs(p, q)[0])


def iou_pairs(p, q):
    """Elementwise exact IoU; p, q: [N, 8] -> [N]."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    inter = intersection_area(p, q)
    pa = np.abs(_signed_area(p.reshape(-1, 4, 2), np.full(len(p), 4)))
    qa = np.abs(_signed_area(q.reshape(-1, 4, 2), np.full(len(q), 4)))
    union = pa + qa - inter
    # Degenerate-union convention from polyiou.cpp:121-126
    return np.where(union == 0.0, (inter + 1.0) / (union + 1.0), inter / union)


def iou_matrix(p, q):
    """Pairwise exact IoU matrix; p [N, 8], q [M, 8] -> [N, M]."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    n, m = len(p), len(q)
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=np.float64)
    pp = np.repeat(p, m, axis=0)
    qq = np.tile(q, (n, 1))
    return iou_pairs(pp, qq).reshape(n, m)


def iou_poly_pairs(p, q) -> np.ndarray:
    """Elementwise IoU; p, q [N, 8] -> [N] float64."""
    return iou_pairs(np.ascontiguousarray(p, np.float64), np.ascontiguousarray(q, np.float64))


NMS_BLOCK = 256  # candidates per block of poly_nms's greedy walk


def _hboxes(boxes):
    return np.stack([boxes[:, 0::2].min(1), boxes[:, 1::2].min(1),
                     boxes[:, 0::2].max(1), boxes[:, 1::2].max(1)], axis=1)


def _hbox_overlap(a, b):
    """[len(a), len(b)]: hboxes not separated, the loop's prefilter (a NaN
    coordinate separates nothing)."""
    return ~((a[:, None, 0] > b[None, :, 2]) | (b[None, :, 0] > a[:, None, 2])
             | (a[:, None, 1] > b[None, :, 3]) | (b[None, :, 1] > a[:, None, 3]))


def poly_nms(boxes, scores, thresh: float) -> np.ndarray:
    """Greedy rotated NMS over one class group with an axis-aligned
    prefilter; returns keep [N] bool, equal to ``poly_nms_plain``'s.

    Candidates go in score order (stable), NMS_BLOCK at a time: a block's
    rows are first tested against every box kept before the block, then
    among themselves, each pair whose hboxes overlap through one batched
    ``iou_pairs`` (later box first, as the loop calls ``iou_poly``: the
    same float64 arithmetic per pair), and the greedy walk runs over the
    block's boolean suppression matrix."""
    boxes = np.ascontiguousarray(boxes, np.float64)
    scores = np.ascontiguousarray(scores, np.float64)
    n = len(boxes)
    keep = np.zeros(n, bool)
    if n == 0:
        return keep
    order = np.argsort(-scores, kind="stable")
    b = boxes[order]
    hb = _hboxes(b)
    kept = np.zeros(0, np.int64)  # positions in score order
    for start in range(0, n, NMS_BLOCK):
        rows = np.arange(start, min(start + NMS_BLOCK, n))
        suppressed = np.zeros(len(rows), bool)
        if len(kept):
            ii, jj = np.nonzero(_hbox_overlap(hb[rows], hb[kept]))
            if len(ii):
                hit = iou_pairs(b[rows[ii]], b[kept[jj]]) > thresh
                suppressed[ii[hit]] = True
        live = rows[~suppressed]
        ii, jj = np.nonzero(np.tril(_hbox_overlap(hb[live], hb[live]), -1))
        s = np.zeros((len(live), len(live)), bool)  # s[i, j]: j < i suppresses i
        if len(ii):
            s[ii, jj] = iou_pairs(b[live[ii]], b[live[jj]]) > thresh
        alive = np.ones(len(live), bool)
        for t in range(len(live)):
            if alive[t]:
                alive[t + 1:] &= ~s[t + 1:, t]
        kept = np.concatenate([kept, live[alive]])
    keep[order[kept]] = True
    return keep


def poly_nms_plain(boxes, scores, thresh: float) -> np.ndarray:
    """``poly_nms`` one pair at a time, the plain reference: each candidate
    in score order against each kept box whose hbox overlaps
    (py_cpu_nms_poly_fast semantics)."""
    boxes = np.ascontiguousarray(boxes, np.float64)
    scores = np.ascontiguousarray(scores, np.float64)
    n = len(boxes)
    keep = np.zeros(n, bool)
    if n == 0:
        return keep
    order = np.argsort(-scores, kind="stable")
    hb = np.stack([boxes[:, 0::2].min(1), boxes[:, 1::2].min(1),
                   boxes[:, 0::2].max(1), boxes[:, 1::2].max(1)], axis=1)
    kept: list = []
    for i in order:
        ok = True
        for j in kept:
            if (hb[i, 0] > hb[j, 2] or hb[j, 0] > hb[i, 2]
                    or hb[i, 1] > hb[j, 3] or hb[j, 1] > hb[i, 3]):
                continue
            if iou_poly(boxes[i], boxes[j]) > thresh:
                ok = False
                break
        if ok:
            kept.append(i)
            keep[i] = True
    return keep
