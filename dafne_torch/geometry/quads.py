"""Quadrilateral geometry primitives on torch tensors.

Counterpart of ``dafne_tpu/geometry/quads.py``.  Quads are ``[..., 8]``
corner arrays ``(x0, y0, ..., x3, y3)``.  The training functions
(``point_to_line_distance`` to ``centerness_targets``, JAX file lines
146-217) keep the JAX functions' op order.
"""

from __future__ import annotations

import torch


def quad_signed_area(corners: torch.Tensor) -> torch.Tensor:
    """Signed shoelace area of quads [..., 8]; positive for CCW order."""
    c = corners.reshape(corners.shape[:-1] + (4, 2))
    nxt = torch.roll(c, shifts=-1, dims=-2)
    return 0.5 * torch.sum(c[..., 0] * nxt[..., 1] - nxt[..., 0] * c[..., 1], -1)


def quad_area(corners: torch.Tensor) -> torch.Tensor:
    """Absolute shoelace area of quads [..., 8]."""
    return quad_signed_area(corners).abs()


def enclosing_hbox(corners: torch.Tensor) -> torch.Tensor:
    """Axis-aligned enclosing box (xmin, ymin, xmax, ymax) of quads [..., 8]."""
    xs = corners[..., 0::2]
    ys = corners[..., 1::2]
    return torch.stack(
        [xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)], dim=-1
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none is)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def sort_quadrilateral(corners: torch.Tensor) -> torch.Tensor:
    """Canonical corner order ("Algorithm 1" of the Modulated Loss paper).

    The same decisions as the JAX function, element for element:
      - p1 = the vertex with minimal x (first index on ties);
      - p3 = the first remaining vertex whose line through p1 separates the
        other two (the diagonal partner), else the first remaining vertex;
      - p2 = the leftover candidate a if cross(p3-p1, a-p1) > 0, or if both
        leftovers have a non-positive cross; else b.  p4 is the other one.
    The JAX version permutes with one-hot matmuls (a TPU workaround); here
    the permutation is a gather, which gives the same values.
    """
    shape = corners.shape
    c = corners.reshape(-1, 4, 2)
    ar4 = torch.arange(4, device=c.device)

    left = torch.argmin(c[:, :, 0], dim=1)
    p1 = torch.gather(c, 1, left[:, None, None].expand(-1, 1, 2))  # [N, 1, 2]
    v = c - p1
    # cross[n, j, k] = cross2d(v_j, v_k)
    cross = v[:, :, None, 0] * v[:, None, :, 1] - v[:, :, None, 1] * v[:, None, :, 0]

    not_left = ar4[None, :] != left[:, None]  # [N, 4]
    eye = torch.eye(4, dtype=torch.bool, device=c.device)
    others = not_left[:, None, :] & ~eye[None]  # [N, j, k]
    pair_prod = torch.where(others, cross, torch.ones_like(cross)).prod(dim=2)
    cond = (pair_prod < 0.0) & not_left
    idx_p3 = torch.where(cond.any(dim=1), _first_true(cond), _first_true(not_left))

    leftover = not_left & (ar4[None, :] != idx_p3[:, None])  # two True
    idx_a = _first_true(leftover)
    idx_b = (ar4[None, :] * leftover).sum(dim=1) - idx_a

    cross_p3 = torch.gather(cross, 1, idx_p3[:, None, None].expand(-1, 1, 4))[:, 0]
    ca = torch.gather(cross_p3, 1, idx_a[:, None])[:, 0]
    cb = torch.gather(cross_p3, 1, idx_b[:, None])[:, 0]
    take_a = (ca > 0.0) | ((ca <= 0.0) & (cb <= 0.0))
    idx_p2 = torch.where(take_a, idx_a, idx_b)
    idx_p4 = torch.where(take_a, idx_b, idx_a)

    perm = torch.stack([left, idx_p2, idx_p3, idx_p4], dim=1)  # [N, 4]
    out = torch.gather(c, 1, perm[:, :, None].expand(-1, 4, 2))
    return out.reshape(shape)


def point_to_line_distance(p1, p2, x0, y0):
    """Distance from (x0, y0) to the infinite line through p1, p2 ([..., 2]).
    No epsilon guard: a degenerate edge gives NaN, which
    `centerness_targets` flushes to 0."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    nom = ((y2 - y1) * x0 - (x2 - x1) * y0 + x2 * y1 - y2 * x1).abs()
    denom = torch.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
    return nom / denom


def compute_abcd(corners: torch.Tensor, locations: torch.Tensor) -> torch.Tensor:
    """[..., 4] distances from locations [..., 2] to the edges c0c1, c1c2,
    c2c3, c3c0 of quads [..., 8] (broadcast over the leading axes)."""
    c = corners.reshape(corners.shape[:-1] + (4, 2))
    nxt = torch.roll(c, shifts=-1, dims=-2)
    return point_to_line_distance(c, nxt, locations[..., None, 0], locations[..., None, 1])


def _triangle_area(a, b, c):
    """Area of triangles with vertices a, b, c ([..., 2])."""
    u, v = a - c, b - c
    return 0.5 * (u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]).abs()


def is_in_quadrilateral(corners, quad_area_val, locations, eps: float = 1e-3):
    """[...] bool: the four (edge, point) triangles' areas sum to no more
    than the quad's area + eps, i.e. the point lies inside."""
    c = corners.reshape(corners.shape[:-1] + (4, 2))
    nxt = torch.roll(c, shifts=-1, dims=-2)
    tri = _triangle_area(c, nxt, locations[..., None, :])
    return ~(tri.sum(-1) > (quad_area_val + eps))


def centerness_targets(reg_targets: torch.Tensor, alpha) -> torch.Tensor:
    """((min/max)(0, 2) * (min/max)(1, 3)) ** (1 / alpha) over ltrb or abcd
    4-vectors [..., 4]; NaN and infinities flush to 0."""
    lr = reg_targets[..., 0::2]
    tb = reg_targets[..., 1::2]
    ctr = (lr.amin(-1) / lr.amax(-1)) * (tb.amin(-1) / tb.amax(-1))
    ctr = ctr ** (1.0 / alpha)
    return torch.nan_to_num(ctr, nan=0.0, posinf=0.0, neginf=0.0)
