"""The 2-D tiled suppression path (K2), per-class-group NMS and the grouped
decode, port vs JAX.

K2 cannot run on the CPU: its plain version, held here to the Pallas 2-D
kernel in interpret mode, is what chip_smoke.py holds the kernel to on the
card (K2 writes S as bit rows; the plain S packed is its CPU route).  The JAX side runs on the CPU with impl="xla", and with "pallas-2d"
in interpret mode (the Pallas call patched as tests/test_pallas_nms.py
does); nothing in dafne_tpu changes.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dafne_tpu.ops.nms as jax_nms
import dafne_tpu.ops.pallas.quad_nms as jax_qn
from dafne_tpu.models.head import compute_locations as jax_compute_locations
from dafne_tpu.ops.postprocess import DecodeSpec as JaxDecodeSpec
from dafne_tpu.ops.postprocess import decode_detections as jax_decode

from dafne_torch.ops.kernels.quad_nms import (
    TILE,
    TILE_2D,
    live_blocks,
    pack_suppression_bits,
    suppression_bits_2d,
    suppression_bits_2d_cuda,
    suppression_matrix,
)
from dafne_torch.ops.nms import (
    group_budget,
    rotated_nms,
    rotated_nms_grouped,
    rotated_nms_grouped_batched,
)
from dafne_torch.ops.postprocess import DecodeSpec, decode_detections

from test_torch_decode import STRIDES, _head_outputs
from test_torch_model import narrow_cfgs
from test_torch_quad_nms import _random_boxes

torch.set_num_threads(1)


def _score_ordered(n, n_classes, seed, dup=0.4, invalid=0.2):
    """Candidates in score order (classes interleaved, not class-major):
    CCW corners with near-duplicate clusters, classes with invalid (-1)
    slots scattered among them."""
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(n, seed=seed, extent=140.0)
    k = int(dup * n)
    src = rng.randint(0, n - k, k)
    boxes[n - k:] = boxes[src] + rng.uniform(-2, 2, (k, 8)).astype(np.float32)
    boxes = boxes[rng.permutation(n)]
    corners = np.array(jax_nms._as_ccw_rows(jnp.asarray(boxes)))
    classes = rng.randint(0, n_classes, n).astype(np.int32)
    classes[rng.rand(n) < invalid] = -1
    return corners, classes


@pytest.mark.parametrize("n", [TILE, 3 * TILE])
def test_2d_path_equals_pallas_2d_kernel(n):
    """The port's class_major=False suppression matrix (on the CPU, the
    plain version of K2) equals the Pallas 2-D kernel entry for entry, and
    its bit rows (suppression_bits_2d) the packed Pallas S; every nonzero
    lies in a tile that K2 computes (live_blocks at TILE_2D)."""
    corners, classes = _score_ordered(n, 4, seed=n)
    want = np.array(jax_qn.suppression_matrix(jnp.asarray(corners), jnp.asarray(classes), 0.1,
                                              interpret=True))
    tc, tk = torch.from_numpy(corners)[None], torch.from_numpy(classes)[None]
    got = suppression_matrix(tc, tk, 0.1, class_major=False)[0].numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(suppression_bits_2d(tc, tk, 0.1)[0].numpy(),
                                  pack_suppression_bits(torch.from_numpy(want)[None])[0].numpy())
    tiles = live_blocks(tk, TILE_2D, TILE_2D)[0].numpy()
    mask = np.kron(tiles, np.ones((TILE_2D, TILE_2D), bool))
    assert not (got.astype(bool) & ~mask).any()


def test_tile_interactions_is_the_pallas_interaction_test():
    """K2's live tiles (live_blocks at TILE_2D) against the Pallas kernel's
    interaction test, `(j >= i) & any(rcls == ccls)` with its -1/-2
    sentinels: above the diagonal they are the same tiles; on it, a tile
    is live only when two of its slots i < j share a valid class, which the
    Pallas test does not ask; all-invalid tiles never interact."""
    n = 5 * TILE_2D
    rng = np.random.RandomState(3)
    classes = rng.randint(0, 40, (2, n)).astype(np.int32)
    classes[:, 2 * TILE_2D:3 * TILE_2D] = -1  # an all-invalid tile
    classes[1, 3 * TILE_2D:] = rng.randint(40, 43, 2 * TILE_2D)  # classes seen only there
    classes[0, :TILE_2D] = np.arange(TILE_2D)  # a diagonal tile of distinct classes
    got = live_blocks(torch.from_numpy(classes), TILE_2D, TILE_2D).numpy()
    t = n // TILE_2D
    pallas = np.zeros((2, t, t), bool)
    want = np.zeros((2, t, t), bool)
    for b in range(2):
        for i in range(t):
            rows = classes[b, i * TILE_2D:(i + 1) * TILE_2D]
            for j in range(i, t):
                cols = classes[b, j * TILE_2D:(j + 1) * TILE_2D]
                pallas[b, i, j] = bool(np.intersect1d(rows[rows >= 0], cols[cols >= 0]).size)
                valid = rows[rows >= 0]
                want[b, i, j] = pallas[b, i, j] if j > i else len(np.unique(valid)) < len(valid)
    np.testing.assert_array_equal(got, want)
    assert not (got & ~pallas).any() and (pallas & ~got).any()  # tile (0, 0) of image 0
    assert not got[:, 2, :].any() and not got[:, :, 2].any()
    assert got[0].any() and not got[0].all()


def test_2d_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        suppression_bits_2d_cuda(torch.zeros(1, TILE, 8), torch.zeros(1, TILE, dtype=torch.int32),
                                 0.1)
    assert suppression_bits_2d_cuda.launches == 0


def _grouped_inputs(n, seed, n_classes=15, dense_class=None):
    """Boxes with near-duplicate clusters; `dense_class` takes most of them
    so that its group overflows a small budget."""
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(n, seed=seed, extent=600.0)
    boxes[n // 2:] = boxes[: n - n // 2] + rng.uniform(-4, 4, (n - n // 2, 8)).astype(np.float32)
    # quantized scores: exact ties, resolved by index in both top-ks
    scores = (np.round(rng.uniform(0.05, 1.0, n) * 40) / 40).astype(np.float32)
    classes = rng.randint(0, n_classes, n).astype(np.int32)
    if dense_class is not None:
        classes[rng.rand(n) < 0.6] = dense_class
    valid = rng.rand(n) > 0.15
    return boxes, np.where(valid, scores, 0.0).astype(np.float32), classes, valid


def _interpret_pallas(monkeypatch):
    orig = jax_qn.suppression_matrix
    monkeypatch.setattr(jax_qn, "suppression_matrix",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


GROUPED_CASES = {
    # no group over K = 256: equal to the global class-aware NMS
    "within-budget": dict(n=600, group_k=256, dense_class=None),
    # class 3 holds ~400 of 600 candidates against K = 64: the group keeps
    # its top 64, and groups with fewer members pad with repeated indices
    "overflow": dict(n=600, group_k=64, dense_class=3),
}


@pytest.mark.parametrize("jax_impl", ["xla", "pallas-2d"])
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_rotated_nms_grouped_equals_jax(case, jax_impl, monkeypatch):
    c = GROUPED_CASES[case]
    boxes, scores, classes, valid = _grouped_inputs(c["n"], seed=len(case), dense_class=c["dense_class"])
    if jax_impl.startswith("pallas"):
        _interpret_pallas(monkeypatch)
    args = (0.1, ((5, 4),), 15, c["group_k"], 0)
    want = np.asarray(jax_nms.rotated_nms_grouped(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid), *args,
        impl=jax_impl))
    t = [torch.from_numpy(a) for a in (boxes, scores, classes, valid)]
    for impl in ("auto", "pallas-2d", "xla"):
        np.testing.assert_array_equal(rotated_nms_grouped(*t, *args, impl=impl).numpy(), want,
                                      err_msg=impl)
    assert 0 < want.sum() < valid.sum()
    merged = np.where(classes == 5, 4, classes)
    overflowing = np.bincount(merged[valid], minlength=15).max() > c["group_k"]
    assert overflowing == (case == "overflow")
    if not overflowing:
        glob = rotated_nms(*[x[None] for x in t], 0.1, ((5, 4),))[0].numpy()
        np.testing.assert_array_equal(want, glob)


def test_grouped_batched_equals_jax_batched():
    """Two images in one call: one [B * G, K] problem batch, per-image
    keep-sets equal to the JAX vmap."""
    per = [_grouped_inputs(300, seed=s, dense_class=2) for s in (7, 8)]
    stack = [np.stack([p[i] for p in per]) for i in range(4)]
    args = (0.1, ((5, 4),), 15, 32, 100)
    want = np.asarray(jax_nms.rotated_nms_grouped_batched(*[jnp.asarray(a) for a in stack], *args,
                                                          impl="xla"))
    got = rotated_nms_grouped_batched(*[torch.from_numpy(a) for a in stack], *args).numpy()
    np.testing.assert_array_equal(got, want)
    assert group_budget(300, 15, ((5, 4),), 32, 100) == ([c for c in range(15) if c != 5], 32)
    assert group_budget(300, 15, ((5, 4),), 32, 4096)[1] == 293  # ceil(4096 / 14)


GROUPED_DECODE = {
    # K = 64 per group: the busiest groups overflow their budget
    "group-64": ["TPU.NMS_GROUP_CANDIDATES", "64", "TPU.NMS_MAX_CANDIDATES", "256"],
    # K = ceil(4096 / 14) = 293 (min_total), the un-mixed reported score
    "group-min-total": ["TPU.NMS_GROUP_CANDIDATES", "32", "TPU.NMS_MAX_CANDIDATES", "4096",
                        "MODEL.DAFNE.CENTERNESS_USE_IN_SCORE", "False"],
}


@pytest.mark.parametrize("case", sorted(GROUPED_DECODE))
def test_grouped_decode_equal_on_shared_head_outputs(case):
    """NMS_GROUP_CANDIDATES > 0: every per-level survivor (no global cap)
    into grouped NMS, then the post-NMS top-k.  The same detections (valid
    slots and classes exactly; values at float32 rounding, as the global
    decode test)."""
    jcfg, tcfg = narrow_cfgs(GROUPED_DECODE[case] + ["MODEL.DAFNE.PRE_NMS_TOPK_TEST", "600",
                                                    "MODEL.DAFNE.POST_NMS_TOPK_TEST", "200"])
    head = _head_outputs(256, 2, 15, seed=11 + len(case))
    scale = np.array([[1.5, 2.0], [0.5, 1.0]], np.float32)
    locs = [jax_compute_locations(-(-256 // s), -(-256 // s), s) for s in STRIDES]
    jspec = JaxDecodeSpec.from_config(jcfg)
    spec = DecodeSpec.from_config(tcfg)
    assert spec.nms_group_candidates == jspec.nms_group_candidates > 0
    want = jax.jit(lambda h, sc: jax_decode(h, locs, jspec, sc))(
        jax.tree_util.tree_map(jnp.asarray, head), jnp.asarray(scale))
    got = decode_detections({k: [torch.from_numpy(a) for a in v] for k, v in head.items()}, spec,
                            torch.from_numpy(scale))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    assert (want["valid"].sum(1) == 200).all()
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["centerness"], want["centerness"], rtol=0, atol=1e-6)
    for key in ("corners", "hboxes", "locations"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)


def test_decode_spec_from_config_matches_jax():
    jcfg, tcfg = narrow_cfgs(["TPU.NMS_GROUP_CANDIDATES", "128",
                              "MODEL.DAFNE.INFERENCE_TH_TRAIN", "0.2",
                              "MODEL.DAFNE.PRE_NMS_TOPK_TRAIN", "700",
                              "MODEL.DAFNE.POST_NMS_TOPK_TRAIN", "70"])
    for train in (False, True):
        want = JaxDecodeSpec.from_config(jcfg, train=train)
        got = DecodeSpec.from_config(tcfg, train=train)
        for field in ("strides", "num_classes", "pre_nms_thresh", "pre_nms_topk", "post_nms_topk",
                      "nms_threshold", "nms_max_candidates", "nms_group_candidates",
                      "class_merge"):
            assert getattr(got, field) == getattr(want, field), (field, train)
