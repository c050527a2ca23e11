"""S as bit rows (the interface between K1 and the greedy kernel), port vs JAX.

The strip kernel (K1) and the 2-D tiled kernel (K2) write S as [B, N, N / 32]
int32 words and the greedy kernel walks them; none runs on the CPU.  On CPU tensors the dispatchers
take the plain versions (the packed plain S, the plain walk over the
unpacked bits), held here to the Pallas strip kernel in interpret mode and
to JAX's ``greedy_scan``; chip_smoke.py holds the kernels to the same plain
versions on the card.  Every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dafne_tpu.ops.nms as jax_nms
import dafne_tpu.ops.pallas.quad_nms as jax_qn
from dafne_tpu.ops.nms import _as_ccw_rows as jax_as_ccw_rows
from dafne_tpu.ops.pallas.quad_nms import greedy_scan

from dafne_torch.ops.kernels.quad_nms import (
    TILE,
    greedy_keep_bits,
    greedy_keep_bits_cuda,
    greedy_keep_plain,
    pack_suppression_bits,
    suppression_bits,
    suppression_bits_2d,
    unpack_suppression_bits,
)
from dafne_torch.ops.nms import rotated_nms

from test_torch_nms_grouped import _interpret_pallas, _score_ordered
from test_torch_quad_nms import _class_major, _jax_s, _random_boxes

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [128, 512, 640])
def test_pack_unpack_round_trip_and_bit_order(n):
    """unpack(pack(S)) == S, and bit k of word w in row i is S[i, 32 w + k]
    (bit 31 included: the int32 word is negative)."""
    rng = np.random.RandomState(n)
    s = (rng.uniform(size=(2, n, n)) < 0.3).astype(np.int8)
    bits = pack_suppression_bits(torch.from_numpy(s))
    assert bits.dtype == torch.int32 and bits.shape == (2, n, n // 32)
    np.testing.assert_array_equal(unpack_suppression_bits(bits).numpy(), s)
    words = bits.numpy().view(np.uint32)
    for b, i, j in zip(rng.randint(0, 2, 50), rng.randint(0, n, 50), rng.randint(0, n, 50)):
        assert (words[b, i, j // 32] >> np.uint32(j % 32)) & 1 == s[b, i, j]
    one = np.zeros((1, n, n), np.int8)
    one[0, 3, 63] = 1
    np.testing.assert_array_equal(pack_suppression_bits(torch.from_numpy(one))[0, 3].numpy(),
                                  np.where(np.arange(n // 32) == 1, np.int32(-2**31), 0))


@pytest.mark.parametrize(
    "n,n_valid,n_classes,thr,dup",
    [(256, 256, 3, 0.1, 0.0), (384, 300, 6, 0.25, 0.3), (512, 200, 15, 0.1, 0.5)],
)
def test_suppression_bits_equal_packed_pallas_strip(n, n_valid, n_classes, thr, dup):
    """The cases of test_plain_suppression_equals_pallas_strip: the bit rows
    on the CPU equal the packed Pallas strip S word for word."""
    rng = np.random.RandomState(n + n_valid)
    boxes = _random_boxes(n, seed=n, extent=150.0)
    k = int(dup * n)
    boxes[n - k :] = boxes[rng.randint(0, n, k)] + rng.uniform(-2, 2, (k, 8)).astype(np.float32)
    corners = np.array(jax_as_ccw_rows(jnp.asarray(boxes)))
    classes = _class_major(n, n_valid, n_classes, rng)
    want = pack_suppression_bits(torch.from_numpy(np.array(_jax_s(corners, classes, thr)))[None])
    got = suppression_bits(torch.from_numpy(corners)[None], torch.from_numpy(classes)[None], thr)
    assert got.dtype == torch.int32 and got.shape == (1, n, n // 32) and want.any()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _upper(rng, b, n, density, chain):
    sup = rng.uniform(size=(b, n, n)) < density
    if chain:
        links = np.arange(n - 1)
        sup[:, links, links + 1] = True  # row i suppresses i + 1: a chain through every row
    return np.triu(sup, k=1).astype(np.int8)


GREEDY_CASES = {
    "n128-d0.02": dict(n=128, density=0.02, chain=True),
    "n128-d0.3": dict(n=128, density=0.3, chain=True),
    "n640-d0.02": dict(n=640, density=0.02, chain=True),
    "n640-d0.3": dict(n=640, density=0.3, chain=True),
    "n4096-d0.001": dict(n=4096, density=0.001, chain=False),
}


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_bits_plain_equals_greedy_scan(case):
    """A batch of problems with different keep_init: the walk over bit rows
    equals JAX's blocked greedy_scan on each, and the int8 walk on S."""
    c = GREEDY_CASES[case]
    rng = np.random.default_rng(c["n"])
    b = 1 if c["n"] > 1024 else 3
    sup = _upper(rng, b, c["n"], c["density"], c["chain"])
    valid = rng.uniform(size=(b, c["n"])) > rng.uniform(0.0, 0.5, (b, 1))
    got = greedy_keep_bits(pack_suppression_bits(torch.from_numpy(sup)), torch.from_numpy(valid))
    for p in range(b):
        want = np.asarray(greedy_scan(jnp.asarray(sup[p]), jnp.asarray(valid[p]), block=128))
        np.testing.assert_array_equal(got[p].numpy(), want, err_msg=f"problem {p}")
    np.testing.assert_array_equal(
        got.numpy(), greedy_keep_plain(torch.from_numpy(sup), torch.from_numpy(valid)).numpy())
    assert 0 < got.sum() < valid.sum()


def test_greedy_bits_plain_all_invalid_and_lower_triangle():
    """keep_init all False keeps nothing; bits on or below the diagonal are
    not read, as the int8 walk reads only j > i."""
    rng = np.random.default_rng(1)
    n = 256
    s = (rng.uniform(size=(2, n, n)) < 0.2).astype(np.int8)  # full, not triangular
    bits = pack_suppression_bits(torch.from_numpy(s))
    none = torch.zeros((2, n), dtype=torch.bool)
    assert not greedy_keep_bits(bits, none).any()
    init = torch.from_numpy(rng.uniform(size=(2, n)) > 0.2)
    np.testing.assert_array_equal(greedy_keep_bits(bits, init).numpy(),
                                  greedy_keep_plain(torch.from_numpy(s), init).numpy())
    want = np.asarray(greedy_scan(jnp.asarray(np.triu(s[0], 1)), jnp.asarray(init[0].numpy()),
                                  block=TILE))
    np.testing.assert_array_equal(greedy_keep_bits(bits, init)[0].numpy(), want)


@pytest.mark.parametrize("n,accepted", [(9088, True), (49152, True), (49280, False)])
def test_greedy_wrapper_takes_n_up_to_49152(n, accepted):
    """The greedy kernel's wrapper takes N up to 49152, the NMS input with no
    candidate cap (TPU.NMS_MAX_CANDIDATES <= 0: ~9 000 per-level survivors
    at DOTA 1024^2, padded to 9088) included.  On CPU tensors an accepted N
    gets as far as the device check and launches nothing."""
    keep_init = torch.ones((1, n), dtype=torch.bool)
    match = "expected a CUDA tensor" if accepted else "N <= 49152"
    with pytest.raises(ValueError, match=match):
        greedy_keep_bits_cuda(torch.zeros((1, 1, 1), dtype=torch.int32), keep_init)
    assert greedy_keep_bits_cuda.launches == 0


@pytest.mark.parametrize("n,n_classes,dup", [(128, 3, 0.4), (512, 15, 0.4), (512, 4, 0.0)])
def test_suppression_bits_2d_equal_packed_pallas_2d(n, n_classes, dup):
    """K2's CPU route (suppression_bits_2d: the plain S, packed) on
    score-ordered candidates, near-duplicates included, equals the packed S
    of the Pallas 2-D kernel in interpret mode word for word."""
    corners, classes = _score_ordered(n, n_classes, seed=n + n_classes, dup=dup)
    want = np.array(jax_qn.suppression_matrix(jnp.asarray(corners), jnp.asarray(classes), 0.1,
                                              interpret=True, class_major=False))
    got = suppression_bits_2d(torch.from_numpy(corners)[None], torch.from_numpy(classes)[None],
                              0.1)
    assert got.dtype == torch.int32 and got.shape == (1, n, n // 32) and want.any()
    np.testing.assert_array_equal(got.numpy(), pack_suppression_bits(torch.from_numpy(want)[None]))


@pytest.mark.parametrize("n,n_classes", [(200, 3), (600, 15)])
def test_pallas_2d_keep_sets_equal_jax(n, n_classes, monkeypatch):
    """rotated_nms(impl="pallas-2d"), whose bit rows go straight to the
    greedy walk, keeps the same boxes as JAX's rotated_nms(impl="pallas-2d")
    (Pallas in interpret mode), and as impl="pallas"."""
    _interpret_pallas(monkeypatch)
    rng = np.random.RandomState(n)
    boxes = _random_boxes(n, seed=n, extent=200.0)
    boxes[n // 2:] = boxes[: n - n // 2] + rng.uniform(-3, 3, (n - n // 2, 8)).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    classes = rng.randint(0, n_classes, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    want = np.asarray(jax_nms.rotated_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                          jnp.asarray(classes), jnp.asarray(valid), 0.1,
                                          impl="pallas-2d"))
    t = [torch.from_numpy(a)[None] for a in (boxes, scores, classes, valid)]
    got = rotated_nms(*t, 0.1, impl="pallas-2d")[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rotated_nms(*t, 0.1, impl="pallas")[0].numpy(), want)
    assert 0 < want.sum() < valid.sum()
