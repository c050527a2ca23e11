"""Exact convex-quadrilateral IoU by clipped boundary line integrals.

Counterpart of the clip method of ``dafne_tpu/geometry/iou.py``:
area(P ∩ Q) = 0.5 ∮ (x dy - y dx) over the intersection's boundary, which
is P's edges clipped to Q plus Q's edges clipped to P (Cyrus–Beck).  All
ops are elementwise over broadcast ``[..., 8]`` quads.
"""

from __future__ import annotations

import torch


def _signed_area_verts(v: torch.Tensor) -> torch.Tensor:
    """Signed shoelace area; v: [..., K, 2]."""
    nxt = torch.roll(v, shifts=-1, dims=-2)
    return 0.5 * torch.sum(v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1], -1)


def _as_ccw_batched(v: torch.Tensor) -> torch.Tensor:
    """[..., 4, 2] -> counter-clockwise vertex order."""
    s = _signed_area_verts(v)
    return torch.where(s[..., None, None] < 0.0, v.flip(-2), v)


def _clipped_edge_integral(a, b, qv, eps: float, include_boundary: bool):
    """0.5 * cross(pa, pb) of edge a->b clipped to the convex CCW quad qv.

    a, b: [..., 2]; qv: [..., 4, 2].  Tolerances are relative to the terms'
    magnitudes, so coincident edges take the parallel branch at any
    coordinate scale.  With ``include_boundary=False`` a piece lying on a
    same-direction edge of qv is dropped: shared boundary counts once.
    """
    d = b - a
    e = torch.roll(qv, shifts=-1, dims=-2) - qv  # [..., 4, 2]
    rel = a[..., None, :] - qv
    num = e[..., 0] * rel[..., 1] - e[..., 1] * rel[..., 0]
    den = e[..., 0] * d[..., None, 1] - e[..., 1] * d[..., None, 0]
    den_tol = eps * (
        (e[..., 0] * d[..., None, 1]).abs() + (e[..., 1] * d[..., None, 0]).abs()
    )
    num_tol = eps * ((e[..., 0] * rel[..., 1]).abs() + (e[..., 1] * rel[..., 0]).abs())

    big = torch.full_like(num, 1e30)
    parallel = den.abs() <= den_tol
    ratio = -num / torch.where(parallel, torch.ones_like(den), den)
    t_low = torch.where(den > den_tol, ratio, -big)
    t_high = torch.where(den < -den_tol, ratio, big)
    outside = parallel & (num < -num_tol)
    if not include_boundary:
        same_dir = (e[..., 0] * d[..., None, 0] + e[..., 1] * d[..., None, 1]) > 0
        outside = outside | (parallel & (num.abs() <= num_tol) & same_dir)
    t_low = torch.where(outside, big, t_low)
    t_high = torch.where(outside, -big, t_high)

    # maximum/minimum, not clamp: at a tie their gradient splits in half, as
    # jnp.maximum's does (rotated_iou_loss differentiates through here)
    t0 = t_low.amax(-1)
    t0 = torch.maximum(t0, torch.zeros_like(t0))
    t1 = t_high.amin(-1)
    t1 = torch.minimum(t1, torch.ones_like(t1))
    pa = a + t0[..., None] * d
    pb = a + t1[..., None] * d
    contrib = 0.5 * (pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0])
    return torch.where(t0 < t1, contrib, torch.zeros_like(contrib))


def quad_intersection_area_clip(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-6):
    """Exact intersection area of convex quads p, q ([..., 8], same shape)."""
    pv = _as_ccw_batched(p.reshape(p.shape[:-1] + (4, 2)))
    qv = _as_ccw_batched(q.reshape(q.shape[:-1] + (4, 2)))
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for k in range(4):
        k1 = (k + 1) % 4
        total = total + _clipped_edge_integral(pv[..., k, :], pv[..., k1, :], qv, eps, True)
        total = total + _clipped_edge_integral(qv[..., k, :], qv[..., k1, :], pv, eps, False)
    return torch.maximum(total, torch.zeros_like(total))


def quad_iou(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Exact IoU of quads ([..., 8], broadcastable); (inter+1)/(union+1)
    when the union is 0.  The clip integral runs at eps >= 1e-6."""
    p, q = torch.broadcast_tensors(p, q)
    inter = quad_intersection_area_clip(p, q, eps=max(eps, 1e-6))
    pa = _signed_area_verts(p.reshape(p.shape[:-1] + (4, 2))).abs()
    qa = _signed_area_verts(q.reshape(q.shape[:-1] + (4, 2))).abs()
    # inter <= min(pa, qa) in real arithmetic; enforcing it keeps union > 0
    inter = torch.minimum(inter, torch.minimum(pa, qa))
    union = pa + qa - inter
    return torch.where(union == 0.0, (inter + 1.0) / (union + 1.0), inter / union)


def quad_iou_matrix(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-7, chunk: int = 256):
    """Pairwise IoU matrix p [N, 8] x q [M, 8] -> [N, M], in row chunks to
    bound the memory of the broadcast intermediates."""
    return torch.cat(
        [quad_iou(p[i : i + chunk, None, :], q[None, :, :], eps)
         for i in range(0, p.shape[0], chunk)],
        dim=0,
    )
