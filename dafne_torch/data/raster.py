"""Polygon filling as OpenCV draws it, in NumPy.

``fill_poly(img, pts, color)`` is ``cv2.fillPoly(img, [pts], color)`` with
``lineType`` 8 and ``shift`` 0, byte for byte, for a polygon whose vertices
lie inside the image (``imgproc/drawing.cpp`` as the OpenCV the JAX package
runs draws it, checked against it by the tests):

- every edge is first drawn as an 8-connected line (``LineIterator``, left
  to right: the major axis steps every pixel, the minor one when the error
  term, started at major - 2 * minor, is negative);
- each non-horizontal edge becomes an active edge in 16.16 fixed point: x
  at its upper end and dx = (x1 - x0) << 16 / (y1 - y0), truncated toward
  zero;
- each row y from the topmost vertex to the image's last row holds the
  edges with y0 <= y < y1, sorted by x, and fills between each pair the
  pixels from ceil(x_left) to floor(x_right); every edge steps by dx per
  row.  Fewer than two edges fill nothing.

A vertex outside the image raises ``NotImplementedError``: OpenCV clips
such edges with its own integer rounding, which is not restated here.

The JAX package draws its ``synthetic_{train,val,test}`` scenes with
``cv2.fillPoly`` (``dafne_tpu/data/datasets/synthetic.py``), every quad
inside the image; this is how the port draws the same pixels without
OpenCV.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def line_pixels(p1: Sequence[int], p2: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of the 8-connected line OpenCV's ``LineIterator`` walks from
    p1 to p2 (left to right)."""
    a, b = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    dx, dy = b[0] - a[0], b[1] - a[1]
    if dx < 0:
        dx, dy, a = -dx, -dy, b
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    steps = np.zeros(major + 1, np.int64)
    err, moved = major - 2 * minor, 0
    for i in range(major + 1):
        steps[i] = moved
        if err < 0:
            moved += 1
            err += 2 * major
        err -= 2 * minor
    along = np.arange(major + 1)
    if vert:
        return a[0] + steps, a[1] + sy * along
    return a[0] + along, a[1] + sy * steps


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], color)`` (8-connected, shift 0) on `img`
    [H, W] or [H, W, C] in place; `pts` [N, 2] integer vertices inside the
    image.  Returns `img`."""
    h, w = img.shape[:2]
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    if len(pts) and ((pts < 0).any() or (pts[:, 0] >= w).any() or (pts[:, 1] >= h).any()):
        raise NotImplementedError(f"fill_poly: a vertex of {pts.tolist()} lies outside the "
                                  f"{w}x{h} image (OpenCV's edge clipping is not ported)")
    value = np.asarray(color, img.dtype).reshape(-1)
    value = value[: img.shape[2]] if img.ndim == 3 else value[0]
    edges = []  # (y0, y1, x at y0, dx)
    for k in range(len(pts)):
        (x0, y0), (x1, y1) = pts[k - 1], pts[k]
        xs, ys = line_pixels((x0, y0), (x1, y1))
        img[ys, xs] = value
        if y0 != y1:
            dx = _trunc_div((int(x1) - int(x0)) << XY_SHIFT, int(y1) - int(y0))
            top = (x0, y0) if y0 < y1 else (x1, y1)
            edges.append((min(y0, y1), max(y0, y1), int(top[0]) << XY_SHIFT, dx))
    if len(edges) < 2:
        return img
    e = np.asarray(edges, np.int64)
    y0, y1, x0, dx = e.T
    ys = np.arange(y0.min(), min(int(y1.max()), h))
    active = (y0[None, :] <= ys[:, None]) & (ys[:, None] < y1[None, :])
    xs = np.where(active, x0[None, :] + (ys[:, None] - y0[None, :]) * dx[None, :],
                  np.iinfo(np.int64).max)
    xs.sort(axis=1)
    n_active = active.sum(axis=1)
    for r in np.nonzero(n_active >= 2)[0]:
        for left, right in xs[r, : n_active[r] - n_active[r] % 2].reshape(-1, 2):
            x_from = (int(left) + XY_ONE - 1) >> XY_SHIFT
            x_to = min(int(right) >> XY_SHIFT, w - 1)
            if x_from <= x_to:
                img[ys[r], x_from: x_to + 1] = value
    return img
