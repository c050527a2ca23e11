"""Port's NMS (plain suppression matrix, greedy walk, rotated_nms) vs JAX.

The CUDA kernels cannot run on the CPU; their plain versions, checked here
against the Pallas kernel in interpret mode and the XLA NMS, are what
chip_smoke.py holds the kernels to on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dafne_tpu.ops.nms import _as_ccw_rows as jax_as_ccw_rows
from dafne_tpu.ops.nms import rotated_nms as jax_rotated_nms
from dafne_tpu.ops.pallas.quad_nms import greedy_scan, suppression_matrix

from dafne_torch.ops.kernels.quad_nms import (
    STRIP,
    TILE,
    greedy_keep_bits_cuda,
    greedy_keep_plain,
    live_blocks,
    suppression_bits_cuda,
    suppression_matrix_plain,
)
from dafne_torch.ops.nms import _as_ccw_rows, rotated_nms

torch.set_num_threads(1)


def _random_boxes(n, seed=0, extent=300.0):
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(0, extent, n), rng.uniform(0, extent, n)
    w, h = rng.uniform(5, 60, n), rng.uniform(5, 40, n)
    ang = rng.uniform(0, np.pi, n)
    base = np.stack(
        [np.stack([-w / 2, -h / 2], -1), np.stack([w / 2, -h / 2], -1),
         np.stack([w / 2, h / 2], -1), np.stack([-w / 2, h / 2], -1)], 1,
    )
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    quads = np.einsum("nkc,ncd->nkd", base, rot) + np.stack([cx, cy], -1)[:, None]
    return quads.reshape(n, 8).astype(np.float32)


def _class_major(n, n_valid, n_classes, rng):
    classes = np.full(n, -1, np.int32)
    classes[:n_valid] = np.sort(rng.randint(0, n_classes, n_valid))
    return classes


def _jax_s(corners_ccw, classes, thr):
    return np.asarray(
        suppression_matrix(jnp.asarray(corners_ccw), jnp.asarray(classes), thr,
                           interpret=True, class_major=True)
    )


def _port_s(corners_ccw, classes, thr):
    return suppression_matrix_plain(
        torch.from_numpy(corners_ccw)[None], torch.from_numpy(classes)[None], thr
    )[0].numpy()


@pytest.mark.parametrize(
    "n,n_valid,n_classes,thr,dup",
    [(256, 256, 3, 0.1, 0.0), (384, 300, 6, 0.25, 0.3), (512, 200, 15, 0.1, 0.5)],
)
def test_plain_suppression_equals_pallas_strip(n, n_valid, n_classes, thr, dup):
    """Class-major boxes, several classes, an invalid tail and (dup > 0)
    near-duplicates: S equal entry for entry."""
    rng = np.random.RandomState(n + n_valid)
    boxes = _random_boxes(n, seed=n, extent=150.0)
    # jittered copies of earlier boxes: IoUs near 1 and on the threshold
    k = int(dup * n)
    src = rng.randint(0, n, k)
    boxes[n - k :] = boxes[src] + rng.uniform(-2, 2, (k, 8)).astype(np.float32)
    corners = np.array(jax_as_ccw_rows(jnp.asarray(boxes)))
    classes = _class_major(n, n_valid, n_classes, rng)
    want = _jax_s(corners, classes, thr)
    got = _port_s(corners, classes, thr)
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_plain_suppression_single_class_and_all_invalid():
    n = 2 * TILE
    corners = np.array(jax_as_ccw_rows(jnp.asarray(_random_boxes(n, seed=13))))
    one = np.zeros(n, np.int32)
    np.testing.assert_array_equal(_port_s(corners, one, 0.3), _jax_s(corners, one, 0.3))
    none = np.full(n, -1, np.int32)
    assert not _port_s(corners, none, 0.3).any()


def test_live_blocks_cover_every_nonzero():
    """The strip kernel's live (strip, column block) blocks hold every
    nonzero of S; a block is live iff it holds a same-class pair j > i."""
    n = 4 * TILE
    rng = np.random.RandomState(5)
    corners = torch.from_numpy(np.array(jax_as_ccw_rows(jnp.asarray(_random_boxes(n, 5, 80.0)))))
    classes = torch.from_numpy(_class_major(n, 400, 4, rng))
    s = suppression_matrix_plain(corners[None], classes[None], 0.1)[0].numpy()
    live = live_blocks(classes[None])[0].numpy()
    mask = np.kron(live, np.ones((STRIP, TILE), bool))
    assert s.any() and not (s.astype(bool) & ~mask).any()
    c = classes.numpy()
    pair = np.triu((c[:, None] == c[None, :]) & (c[:, None] >= 0), 1)
    want = pair.reshape(n // STRIP, STRIP, n // TILE, TILE).any((1, 3))
    np.testing.assert_array_equal(live, want)
    assert not live[-1].any()  # an all-invalid strip loads no corner
    assert live.any() and not live.all()


def test_plain_greedy_equals_greedy_scan():
    """Random S at several densities plus a suppression chain through every
    row: the walk equals the JAX blocked greedy_scan."""
    rng = np.random.default_rng(0)
    n = 640
    for density in (0.02, 0.3):
        sup = rng.uniform(size=(n, n)) < density
        chain = np.arange(n - 1)
        sup[chain, chain + 1] = True
        sup = np.triu(sup, k=1).astype(np.int8)
        valid = rng.uniform(size=n) > 0.1
        want = np.asarray(greedy_scan(jnp.asarray(sup), jnp.asarray(valid), block=128))
        got = greedy_keep_plain(torch.from_numpy(sup)[None], torch.from_numpy(valid)[None])[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(density))


@pytest.mark.parametrize("scores01", [True, False])
@pytest.mark.parametrize("class_merge", [(), ((5, 4),)])
def test_rotated_nms_keep_equals_jax(scores01, class_merge):
    n = 300
    rng = np.random.RandomState(21)
    corners = _random_boxes(n, seed=21, extent=120.0)
    # quantized scores: many exact ties, resolved by input index in both
    scores = (np.round(rng.rand(n) * 20) / 20).astype(np.float32)
    classes = rng.randint(0, 7, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    want = np.asarray(
        jax_rotated_nms(jnp.asarray(corners), jnp.asarray(scores), jnp.asarray(classes),
                        jnp.asarray(valid), 0.1, class_merge, impl="xla", scores01=scores01)
    )
    got = rotated_nms(
        torch.from_numpy(corners)[None], torch.from_numpy(scores)[None],
        torch.from_numpy(classes)[None], torch.from_numpy(valid)[None], 0.1,
        class_merge, scores01=scores01,
    )[0].numpy()
    assert 0 < got.sum() < valid.sum()
    np.testing.assert_array_equal(got, want)


def test_as_ccw_rows_matches_jax():
    boxes = _random_boxes(64, seed=2)
    boxes[::2] = boxes[::2].reshape(-1, 4, 2)[:, ::-1].reshape(-1, 8)  # clockwise half
    np.testing.assert_array_equal(
        _as_ccw_rows(torch.from_numpy(boxes)).numpy(), np.asarray(jax_as_ccw_rows(jnp.asarray(boxes)))
    )


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch only on CUDA tensors; nothing falls back."""
    corners = torch.zeros(1, TILE, 8)
    classes = torch.zeros(1, TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        suppression_bits_cuda(corners, classes, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        greedy_keep_bits_cuda(torch.zeros(1, TILE, TILE // 32, dtype=torch.int32),
                              torch.ones(1, TILE, dtype=torch.bool))
    assert suppression_bits_cuda.launches == 0 and greedy_keep_bits_cuda.launches == 0
