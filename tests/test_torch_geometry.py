"""Port's quad geometry vs the JAX package on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dafne_tpu.geometry import enclosing_hbox as jax_hbox
from dafne_tpu.geometry import quad_area as jax_area
from dafne_tpu.geometry import quad_iou_matrix as jax_iou_matrix
from dafne_tpu.geometry import sort_quadrilateral as jax_sort

from dafne_torch.geometry import enclosing_hbox, quad_area, quad_iou_matrix, sort_quadrilateral

torch.set_num_threads(1)

UNIT_SQ = np.array([0, 0, 1, 0, 1, 1, 0, 1], np.float32)


def _random_convex_quads(n, rng, scale=100.0):
    cx, cy = rng.uniform(0, scale, n), rng.uniform(0, scale, n)
    w, h = rng.uniform(5, scale / 2, n), rng.uniform(5, scale / 2, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    base = np.stack(
        [np.stack([-w / 2, -h / 2], -1), np.stack([w / 2, -h / 2], -1),
         np.stack([w / 2, h / 2], -1), np.stack([-w / 2, h / 2], -1)], axis=1,
    )
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    pts = np.einsum("nij,nkj->nki", rot, base) + np.stack([cx, cy], -1)[:, None, :]
    return pts.reshape(n, 8).astype(np.float32)


def _quads_with_degenerates(rng):
    """10k random quads in shuffled corner order, random (possibly
    self-intersecting) 4-point sets, and degenerate cases: ties in min x,
    repeated points, collinear points, axis-aligned and integer grids."""
    quads = _random_convex_quads(6000, rng)
    perm = np.argsort(rng.rand(6000, 4), axis=1)
    quads = np.take_along_axis(quads.reshape(-1, 4, 2), perm[:, :, None], 1).reshape(-1, 8)
    free = rng.uniform(-50, 50, (2000, 8)).astype(np.float32)
    grid = rng.randint(0, 3, (2000, 8)).astype(np.float32)  # heavy ties
    line = np.repeat(rng.uniform(0, 10, (300, 1, 2)), 4, 1)
    line = line + rng.uniform(0, 1, (300, 4, 1)) * np.array([1.0, 2.0])  # collinear
    special = np.array([
        UNIT_SQ,
        [0, 0, 0, 0, 0, 0, 0, 0],  # one point
        [0, 0, 0, 1, 0, 2, 0, 3],  # all on x = 0
        [1, 1, 0, 0, 1, 1, 0, 0],  # two repeated points
        [0, 0, 2, 2, 0, 2, 2, 0],  # self-intersecting bow-tie
        UNIT_SQ[[6, 7, 4, 5, 2, 3, 0, 1]],  # clockwise
    ], np.float32)
    return np.concatenate([quads, free, grid, line.reshape(-1, 8).astype(np.float32), special])


def test_sort_quadrilateral_exactly_equal():
    quads = _quads_with_degenerates(np.random.RandomState(0))
    assert len(quads) >= 10_000
    want = np.asarray(jax_sort(jnp.asarray(quads)))
    got = sort_quadrilateral(torch.from_numpy(quads)).numpy()
    np.testing.assert_array_equal(got, want)
    # shape-polymorphic like the JAX function
    got3 = sort_quadrilateral(torch.from_numpy(quads[:12].reshape(3, 4, 8))).numpy()
    np.testing.assert_array_equal(got3.reshape(12, 8), want[:12])


def test_area_and_hbox_exactly_equal():
    quads = _quads_with_degenerates(np.random.RandomState(1))[:8000].reshape(-1, 4, 8)
    np.testing.assert_array_equal(quad_area(torch.from_numpy(quads)).numpy(),
                                  np.asarray(jax_area(jnp.asarray(quads))))
    np.testing.assert_array_equal(enclosing_hbox(torch.from_numpy(quads)).numpy(),
                                  np.asarray(jax_hbox(jnp.asarray(quads))))


@pytest.mark.parametrize("scale,atol", [(100.0, 1e-5), (1000.0, 1e-4)])
def test_quad_iou_matrix_matches_jax(scale, atol):
    """atol 1e-5 at the 100-px scale of the JAX geometry tests.  At 1000-px
    image coordinates the clip integral sums products of size ~1e6 down to
    areas of ~1e4, so f32 rounding differences between the two programs
    reach ulp(1e6) / 1e4 ~ 1e-5 relative per term: 1e-4 there."""
    rng = np.random.RandomState(3)
    p = _random_convex_quads(300, rng, scale=scale)
    # near-duplicates, shared edges and identical boxes: the parallel-edge
    # branches of the clip integral
    q = np.concatenate([
        p[:100] + rng.uniform(-0.01, 0.01, (100, 8)).astype(np.float32),
        p[100:150],
        _random_convex_quads(80, rng, scale=scale),
        np.stack([UNIT_SQ, UNIT_SQ + np.array([1, 0] * 4, np.float32),
                  UNIT_SQ + np.array([1, 1] * 4, np.float32)]),
    ])
    want = np.asarray(jax_iou_matrix(jnp.asarray(p), jnp.asarray(q)))
    got = quad_iou_matrix(torch.from_numpy(p), torch.from_numpy(q), chunk=64).numpy()
    assert (got[np.arange(100), np.arange(100)] > 0.99).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
