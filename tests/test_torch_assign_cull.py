"""K3's per-block gt cull, port vs JAX.

The assignment kernel lists, for each block of consecutive locations, the
gts whose clipped center box meets the block's box (and, with the level
filter, whose hbox reaches the block's lowest size range), and runs its pair
body on those alone.  It cannot run on the CPU; its plain forms can:
``gt_lists`` (the cull) and ``assign_argmin_listed`` (the assignment over
the lists).  Here the cull is held to be conservative (every pair whose
value is below INF has its gt in its block's list) on random and crafted
scenes, and the assignment over the lists equal to the Pallas kernel in
interpret mode under the flag variants; chip_smoke.py holds the kernel to
``assign_argmin_plain`` on the card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from dafne_tpu.ops.pallas.assign import assign_argmin as jax_assign_argmin
from dafne_tpu.ops.targets import AssignmentSpec as JaxSpec

from dafne_torch.ops.kernels import assign as A
from dafne_torch.ops.targets import AssignmentSpec

from test_torch_targets import FLAG_CASES, _boundary_ambiguous, _fields, packed_gts, tables

torch.set_num_threads(1)

GT_KEYS = ("gt_corners", "gt_hbox", "gt_area", "gt_valid")


def _finite_pairs(loc, st, rg, gts, spec):
    """[B, K, M] bool: the pairs whose value is below INF, one gt at a time
    through assign_argmin_plain."""
    cor, hb, area, valid = (torch.from_numpy(gts[k]) for k in GT_KEYS)
    m = valid.shape[1]
    out = []
    for j in range(m):
        only = valid & (torch.arange(m) == j)
        min_area, _ = A.assign_argmin_plain(loc, st, rg, cor, hb, area, only, spec)
        out.append(min_area < A.INF)
    return torch.stack(out, -1)


def _check_conservative(loc, st, rg, gts, spec, block):
    """Every finite pair's gt is in its block's list; returns the lists."""
    lists = A.gt_lists(loc, st, rg, torch.from_numpy(gts["gt_hbox"]),
                       torch.from_numpy(gts["gt_valid"]), spec, block)
    finite = _finite_pairs(loc, st, rg, gts, spec)
    k = loc.shape[0]
    per_loc = lists.repeat_interleave(block, 1)[:, :k]  # [B, K, M]
    assert not (finite & ~per_loc).any()
    return lists, finite


def _quad_gts(hboxes):
    """gt arrays [1, m, ...] of valid axis-aligned rectangles with these
    hboxes."""
    hb = np.asarray(hboxes, np.float32).reshape(1, -1, 4)
    x0, y0, x1, y1 = np.moveaxis(hb, -1, 0)
    corners = np.stack([x0, y0, x1, y0, x1, y1, x0, y1], -1).astype(np.float32)
    area = ((x1 - x0) * (y1 - y0)).astype(np.float32)
    return dict(gt_corners=corners, gt_hbox=hb, gt_area=area, gt_valid=np.ones(hb.shape[:2], bool))


@pytest.mark.parametrize("block", [A.BLOCK, 32, 4])
@pytest.mark.parametrize("seed", range(3))
def test_cull_keeps_every_finite_pair_random_scenes(seed, block):
    """Random scenes (duplicates and invalid slots included), the recipe's
    flags: no finite pair is culled, and the cull drops most pairs."""
    spec = AssignmentSpec(num_classes=15)
    loc, st, rg = map(torch.from_numpy, tables((256, 256), spec))
    rng = np.random.RandomState(seed)
    gts = packed_gts(rng, 2, 24, n_max=20, num_classes=15, lo=0.0, hi=256.0, size=(6.0, 150.0))
    gts = {k: np.concatenate([v[:, :12], v[:, :12]], 1) for k, v in gts.items()}  # duplicates
    lists, finite = _check_conservative(loc, st, rg, gts, spec, block)
    assert finite.any()
    counts = A.pair_counts(loc, st, rg, torch.from_numpy(gts["gt_hbox"]),
                           torch.from_numpy(gts["gt_valid"]), spec, block)
    assert int(finite.sum()) <= counts["candidate"] <= counts["listed"] < counts["valid"] / 2


# P3 at 256^2 with stride 8: locations x, y = 4 + 8 i.  The first block of 4
# locations is (4, 4) .. (28, 4).  With radius 2 the center box is the
# center +- 16, clipped to the hbox.  Each case: (hbox, listed in block 0,
# a finite pair in block 0).
EDGE_CASES = {
    # the center box's left edge (cx - 16 = 28) on the block's last x:
    # x - xmin = 0 fails in_center there, so block 0 culls the gt
    "center-edge-on-location": ([20.0, -10.0, 68.0, 30.0], False, False),
    # the hbox's left edge (the clipped box's) on the block's last x
    "hbox-edge-on-location": ([28.0, -10.0, 40.0, 30.0], False, False),
    # one ulp further left: the location at x = 28 passes, the gt is listed
    "hbox-edge-one-ulp-inside": ([float(np.nextafter(np.float32(28.0), np.float32(0.0))), -10.0,
                                  40.0, 30.0], True, True),
    # the clipped box's right edge (cx + 16 = 4) on the block's first x
    "right-edge-on-location": ([-28.0, -10.0, 4.0, 30.0], False, False),
    # a zero-width gt: its box meets the block's, but no location is
    # strictly inside it (the cull is conservative, not exact per location)
    "zero-width": ([12.0, -10.0, 12.0, 30.0], True, False),
    # across the bound between blocks 0 and 1 (x = 28 | 36)
    "straddling-blocks": ([16.0, -10.0, 48.0, 30.0], True, True),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_cull_on_crafted_edges(case):
    """Locations exactly on a clipped center box's edge or an hbox's, one
    ulp inside it, a zero-width gt and a gt across two blocks (each with a
    duplicate): the lists of block 0 are as stated, and no finite pair is
    culled."""
    hbox, listed, finite0 = EDGE_CASES[case]
    spec = AssignmentSpec(num_classes=15, enable_level_size_filtering=False)
    loc, st, rg = map(torch.from_numpy, tables((256, 256), spec))
    lists, finite = _check_conservative(loc, st, rg, _quad_gts([hbox, hbox]), spec, block=4)
    assert bool(lists[0, 0, 0]) == bool(lists[0, 0, 1]) == listed
    assert bool(finite[0, :4, 0].any()) == finite0
    if case == "straddling-blocks":
        assert lists[0, 1, 0] and finite[0, 4:8, 0].any()


def test_level_cull_keeps_large_gts_only():
    """With the level filter, a block whose lowest size range is above a
    gt's larger hbox side does not list it (the last block at 256^2 holds
    P5-P7, lo >= 128, and spans the canvas); without the filter it does."""
    spec = AssignmentSpec(num_classes=15)
    loc, st, rg = map(torch.from_numpy, tables((256, 256), spec))
    gts = _quad_gts([[40.0, 40.0, 100.0, 90.0], [20.0, 20.0, 236.0, 200.0]])  # sides 60, 216
    lists, finite = _check_conservative(loc, st, rg, gts, spec, block=A.BLOCK)
    last = lists.shape[1] - 1
    assert float(rg[last * A.BLOCK:, 0].min()) == 128.0
    assert not lists[0, last, 0] and lists[0, last, 1]
    assert finite[0, :, 0].any()
    uncut = A.gt_lists(loc, st, rg, torch.from_numpy(gts["gt_hbox"]),
                       torch.from_numpy(gts["gt_valid"]),
                       dataclasses.replace(spec, enable_level_size_filtering=False))
    assert uncut[0, last, 0]


@pytest.mark.parametrize("flags", [{"enable_in_box_check": False},
                                   {"combine_center_sample": False},
                                   {"combine_center_sample": False, "center_sample": False}])
def test_uncut_flags_list_every_valid_gt(flags):
    """Where in_center does not decide a pair (the in-box check off, or
    point-in-quad alone) the kernel culls nothing: every block lists every
    valid gt, and the listed pairs are the valid pairs."""
    spec = AssignmentSpec(num_classes=15, **flags)
    assert not A.culls(spec)
    loc, st, rg = map(torch.from_numpy, tables((256, 256), spec))
    gts = packed_gts(np.random.RandomState(1), 2, 16, n_max=12, num_classes=15, lo=0.0, hi=256.0)
    valid = torch.from_numpy(gts["gt_valid"])
    lists = A.gt_lists(loc, st, rg, torch.from_numpy(gts["gt_hbox"]), valid, spec)
    assert torch.equal(lists, valid[:, None, :].expand_as(lists))
    counts = A.pair_counts(loc, st, rg, torch.from_numpy(gts["gt_hbox"]), valid, spec)
    assert counts["listed"] == counts["candidate"] == counts["valid"] == loc.shape[0] * valid.sum()
    assert A.culls(AssignmentSpec(num_classes=15))
    assert A.culls(AssignmentSpec(num_classes=15, center_sample_only=True,
                                  combine_center_sample=False))


@pytest.mark.parametrize("block", [A.BLOCK, 16])
@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_listed_assignment_equals_pallas_interpret(case, block):
    """Assigning each block over its list alone equals assign_argmin_plain
    bit for bit, and the Pallas kernel in interpret mode under the flag
    variants of test_torch_targets.py, with that file's allowance: these
    gts reach areas near 1.4e4, where XLA's FMA contraction on the CPU can
    flip an in-quad test that is ambiguous in float64 (see
    ops/kernels/assign.py); every differing location must be one, at most
    1% of them."""
    m, seed, flags = FLAG_CASES[case]
    spec = AssignmentSpec(num_classes=15, **{"pos_radius": 1.5, **flags})
    loc, st, rg = tables((256, 256), spec)
    rng = np.random.RandomState(seed)
    gts = packed_gts(rng, 1, m, n_max=None, num_classes=15, lo=40.0, hi=216.0, size=(6.0, 120.0))
    args = [torch.from_numpy(gts[k]) for k in GT_KEYS]
    tloc, tst, trg = map(torch.from_numpy, (loc, st, rg))
    got_min, got_arg = A.assign_argmin_listed(tloc, tst, trg, *args, spec, block)
    plain_min, plain_arg = A.assign_argmin_plain(tloc, tst, trg, *args, spec)
    assert torch.equal(got_min, plain_min) and torch.equal(got_arg, plain_arg)
    assert (got_min < A.INF).any()
    run = jax.jit(functools.partial(jax_assign_argmin, spec=JaxSpec(**_fields(spec)),
                                    interpret=True))
    want_min, want_arg = (np.asarray(v) for v in run(loc, st, rg, *(gts[k][0] for k in GT_KEYS)))
    got_min, got_arg = got_min[0].numpy(), got_arg[0].numpy()
    differ = np.flatnonzero((got_min != want_min) | (got_arg != want_arg))
    assert len(differ) <= max(3, loc.shape[0] // 100), len(differ)
    for k in differ:
        gis = {int(a) for a, v in ((got_arg[k], got_min[k]), (want_arg[k], want_min[k]))
               if v < A.INF}
        assert any(_boundary_ambiguous(loc[k], gts["gt_corners"][0, g], gts["gt_area"][0, g])
                   for g in gis), k


@pytest.mark.parametrize("block", [A.BLOCK, 8])
@pytest.mark.parametrize("seed", range(3))
def test_listed_assignment_exact_on_small_gts(seed, block):
    """On the scenes of test_assign_argmin_plain_equals_pallas_interpret
    (gts up to 60 px, two levels, duplicated slots in the last seed), where
    no in-quad test is ambiguous, the assignment over the lists equals the
    Pallas kernel in interpret mode exactly, the first of two equal copies
    winning."""
    spec = AssignmentSpec(strides=(8, 16), sizes_of_interest=(64,), num_classes=3)
    loc, st, rg = tables((128, 128), spec)
    rng = np.random.RandomState(seed)
    gts = packed_gts(rng, 2, 16, n_max=16)
    if seed == 2:
        gts = {k: np.concatenate([v[:, :8], v[:, :8]], 1) for k, v in gts.items()}
    got_min, got_arg = A.assign_argmin_listed(*map(torch.from_numpy, (loc, st, rg)),
                                              *(torch.from_numpy(gts[k]) for k in GT_KEYS),
                                              spec, block)
    run = jax.jit(functools.partial(jax_assign_argmin, spec=JaxSpec(**_fields(spec)),
                                    interpret=True))
    for b in range(2):
        want_min, want_arg = run(loc, st, rg, *(gts[k][b] for k in GT_KEYS))
        np.testing.assert_array_equal(got_min[b].numpy(), np.asarray(want_min))
        np.testing.assert_array_equal(got_arg[b].numpy(), np.asarray(want_arg))
    assert (got_min < A.INF).any()
    if seed == 2:
        assert (got_arg[got_min < A.INF] < 8).all()
