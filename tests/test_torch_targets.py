"""Port's training geometry, assignment kernel (plain version) and targets
vs the JAX package on the same numpy-made inputs.

Small shapes: two FPN levels at 16^2 and 8^2 (strides 8 and 16, a 128^2
image) with 8-32 gt slots, or the five levels of a 256^2 image for the flag
variants.  Tolerances: the geometry at rtol 1e-6 (the same f32 ops); the
assignment argmin exact against the Pallas kernel in interpret mode (the
plain version restates it op for op); targets against the XLA scan exact
except on in-quad boundary locations, where the two triangle-area
summation orders round differently (at most 0.1%, each one checked to be
ambiguous in float64).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.geometry import quads as jq
from dafne_tpu.models.head import compute_locations as jax_compute_locations
from dafne_tpu.ops.pallas.assign import assign_argmin as jax_assign_argmin
from dafne_tpu.ops.targets import AssignmentSpec as JaxSpec
from dafne_tpu.ops.targets import assign_targets as jax_assign_targets
from dafne_tpu.ops.targets import assign_targets_single as jax_assign_targets_single
from dafne_tpu.ops.targets import level_metadata as jax_level_metadata

from dafne_torch.geometry import quads as tq
from dafne_torch.geometry.quads import sort_quadrilateral
from dafne_torch.ops.kernels import assign as K
from dafne_torch.ops.targets import AssignmentSpec, assign_targets, assign_targets_single
from dafne_torch.engine.trainer import make_location_tables

torch.set_num_threads(1)

TWO_LEVELS = dict(strides=(8, 16), sizes_of_interest=(64,), num_classes=3)


def rot_rect_quads(rng, n, lo=10.0, hi=110.0, size=(8.0, 60.0)):
    """[n, 8] f32 rotated rectangles, canonically sorted."""
    cx, cy = rng.uniform(lo, hi, (2, n))
    w, h = rng.uniform(*size, (2, n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    dx = np.stack([-w, w, w, -w], 1) / 2
    dy = np.stack([-h, -h, h, h], 1) / 2
    x = cx[:, None] + dx * c[:, None] - dy * s[:, None]
    y = cy[:, None] + dx * s[:, None] + dy * c[:, None]
    q = np.stack([x, y], -1).reshape(n, 8).astype(np.float32)
    return sort_quadrilateral(torch.from_numpy(q)).numpy()


def packed_gts(rng, b, m, n_max, num_classes=3, **kw):
    """gt arrays [b, m, ...] with 1..n_max valid leading slots per image
    (all m when n_max is None)."""
    corners = np.zeros((b, m, 8), np.float32)
    classes = np.zeros((b, m), np.int32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        n = m if n_max is None else rng.randint(1, n_max + 1)
        corners[i, :n] = rot_rect_quads(rng, n, **kw)
        classes[i, :n] = rng.randint(0, num_classes, n)
        valid[i, :n] = True
    xs, ys = corners[..., 0::2], corners[..., 1::2]
    hbox = np.stack([xs.min(-1), ys.min(-1), xs.max(-1), ys.max(-1)], -1)
    area = np.asarray(jq.quad_area(jnp.asarray(corners))) * valid
    return dict(gt_corners=corners, gt_hbox=hbox.astype(np.float32), gt_classes=classes,
                gt_area=area.astype(np.float32), gt_valid=valid)


def tables(hw, spec):
    """(numpy locations [K, 2], strides [K], ranges [K, 2]) from the port,
    checked equal to the JAX package's tables."""
    _, loc, st, rg = make_location_tables(hw, spec)
    sizes = [((hw[0] + s - 1) // s, (hw[1] + s - 1) // s) for s in spec.strides]
    jloc = np.concatenate([np.asarray(jax_compute_locations(h, w, s))
                           for (h, w), s in zip(sizes, spec.strides)])
    jst, jrg = jax_level_metadata(sizes, JaxSpec(**_fields(spec)))
    np.testing.assert_array_equal(loc.numpy(), jloc)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(rg.numpy(), np.asarray(jrg))
    return loc.numpy(), st.numpy(), rg.numpy()


def _fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def port_targets(loc, st, rg, gts, spec):
    out = assign_targets(*map(torch.from_numpy, (loc, st, rg)),
                         *(torch.from_numpy(gts[k]) for k in
                           ("gt_corners", "gt_hbox", "gt_classes", "gt_area", "gt_valid")),
                         spec)
    return {k: v.numpy() for k, v in out.items()}


def jax_targets(loc, st, rg, gts, spec):
    # eager, not jitted: XLA's fusion contracts the point-to-line products
    # into FMAs, which moves reg_abcd by up to 2e-4 relative near an edge
    jspec = JaxSpec(**{**_fields(spec), "impl": "xla"})
    out = jax_assign_targets(loc, st, rg, gts["gt_corners"], gts["gt_hbox"], gts["gt_classes"],
             gts["gt_area"], gts["gt_valid"], jspec)
    return {k: np.asarray(v) for k, v in out.items()}


# --- geometry ----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_train_geometry_matches_jax(seed):
    rng = np.random.RandomState(seed)
    quads = rot_rect_quads(rng, 64)
    pts = rng.uniform(0, 128, (64, 2)).astype(np.float32)
    area = np.asarray(jq.quad_area(jnp.asarray(quads)))
    c = quads.reshape(-1, 4, 2)
    nxt = np.roll(c, -1, axis=1)
    tc, tn = torch.from_numpy(c), torch.from_numpy(nxt)
    np.testing.assert_allclose(
        tq.point_to_line_distance(tc, tn, torch.from_numpy(pts[:, None, 0]),
                                  torch.from_numpy(pts[:, None, 1])).numpy(),
        np.asarray(jq.point_to_line_distance(c, nxt, pts[:, None, 0], pts[:, None, 1])),
        rtol=1e-6)
    abcd = tq.compute_abcd(torch.from_numpy(quads), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(abcd, np.asarray(jq.compute_abcd(quads, pts)), rtol=1e-6)
    np.testing.assert_allclose(
        tq._triangle_area(tc, tn, torch.from_numpy(pts[:, None, :])).numpy(),
        np.asarray(jq._triangle_area(c, nxt, pts[:, None, :])), rtol=1e-6, atol=1e-6)
    # every point against every quad: inside, outside and near the edges
    got = tq.is_in_quadrilateral(torch.from_numpy(quads)[None], torch.from_numpy(area)[None],
                                 torch.from_numpy(pts)[:, None]).numpy()
    want = np.asarray(jq.is_in_quadrilateral(quads[None], area[None], pts[:, None]))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    # centerness of ltrb/abcd 4-vectors, with zeros and a degenerate NaN row
    reg = np.abs(rng.randn(64, 4)).astype(np.float32)
    reg[0] = 0.0
    reg[1, 2] = 0.0
    for alpha in (1, 5, 2.5):
        np.testing.assert_allclose(tq.centerness_targets(torch.from_numpy(reg), alpha).numpy(),
                                   np.asarray(jq.centerness_targets(reg, alpha)), rtol=1e-6)


# --- the assignment kernel's plain version vs the Pallas kernel ---------------


@pytest.mark.parametrize("seed", range(5))
def test_assign_argmin_plain_equals_pallas_interpret(seed):
    rng = np.random.RandomState(seed)
    spec = AssignmentSpec(**TWO_LEVELS)
    loc, st, rg = tables((128, 128), spec)
    m = [8, 16, 24, 32, 32][seed]
    gts = packed_gts(rng, 3, m, n_max=m)
    if seed == 4:  # duplicated gts: equal areas everywhere they overlap
        gts = {k: np.concatenate([v[:, :16], v[:, :16]], 1) for k, v in gts.items()}
    got_min, got_arg = K.assign_argmin_plain(
        *map(torch.from_numpy, (loc, st, rg)),
        *(torch.from_numpy(gts[k]) for k in ("gt_corners", "gt_hbox", "gt_area", "gt_valid")),
        spec)
    run = jax.jit(functools.partial(jax_assign_argmin, spec=JaxSpec(**_fields(spec)),
                                    interpret=True))
    for b in range(3):
        want_min, want_arg = run(loc, st, rg, gts["gt_corners"][b], gts["gt_hbox"][b],
                                 gts["gt_area"][b], gts["gt_valid"][b])
        np.testing.assert_array_equal(got_min[b].numpy(), np.asarray(want_min))
        np.testing.assert_array_equal(got_arg[b].numpy(), np.asarray(want_arg))
    assert (got_min < K.INF).any()
    if seed == 4:  # every positive takes the first of its two equal copies
        assert (got_arg[got_min < K.INF] < 16).all()


def test_assign_dispatch_by_device():
    spec = AssignmentSpec(**TWO_LEVELS)
    loc, st, rg = (torch.from_numpy(a) for a in tables((128, 128), spec))
    gts = packed_gts(np.random.RandomState(0), 2, 8, 4)
    args = [torch.from_numpy(gts[k]) for k in ("gt_corners", "gt_hbox", "gt_area", "gt_valid")]
    for got, want in zip(K.assign_argmin(loc, st, rg, *args, spec),
                         K.assign_argmin_plain(loc, st, rg, *args, spec)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.assign_argmin_cuda(loc, st, rg, *args, spec)
    with pytest.raises(ValueError, match="CUDA tensor"):  # impl="pallas" asks for the kernel
        assign_targets(loc, st, rg, args[0], args[1], torch.from_numpy(gts["gt_classes"]),
                       args[2], args[3], dataclasses.replace(spec, impl="pallas"))


# --- targets vs the JAX XLA scan ---------------------------------------------


def _boundary_ambiguous(loc, quad, area):
    """True when the f64 in-quad margin of (loc, quad) lies in the f32
    noise band of the triangle-area test."""
    c = quad.astype(np.float64).reshape(4, 2)
    nxt = np.roll(c, -1, 0)
    lx, ly = float(loc[0]), float(loc[1])
    tri = 0.5 * np.abs((c[:, 0] - lx) * (nxt[:, 1] - ly) - (c[:, 1] - ly) * (nxt[:, 0] - lx))
    margin = tri.sum() - (float(area) + 1e-3)
    return abs(margin) <= max(2e-6 * float(area), 2e-3)


def check_targets_match(got, want, loc, gts, spec, allowed):
    """labels/gt_inds equal but on at most `allowed` ambiguous boundary
    locations; reg_* at rtol 1e-6 where the winning gt agrees."""
    mism = np.argwhere(got["gt_inds"] != want["gt_inds"])
    assert len(mism) <= allowed, len(mism)
    for b, k in mism:
        gis = {int(got["gt_inds"][b, k]), int(want["gt_inds"][b, k])} - {-1}
        assert any(_boundary_ambiguous(loc[k], gts["gt_corners"][b, g], gts["gt_area"][b, g])
                   for g in gis), (b, k)
    ok = got["gt_inds"] == want["gt_inds"]
    np.testing.assert_array_equal(got["labels"][ok], want["labels"][ok])
    for key in ("reg_corners", "reg_ltrb", "reg_abcd"):
        np.testing.assert_allclose(got[key][ok], want[key][ok], rtol=1e-6, atol=1e-6, err_msg=key)
    assert (got["labels"] != spec.num_classes).any()


@pytest.mark.parametrize("seed", range(5))
def test_assign_targets_matches_jax_xla(seed):
    rng = np.random.RandomState(100 + seed)
    spec = AssignmentSpec(**TWO_LEVELS)
    loc, st, rg = tables((128, 128), spec)
    gts = packed_gts(rng, 4, [8, 16, 32, 32, 24][seed], n_max=8)
    got = port_targets(loc, st, rg, gts, spec)
    # at most 0.1% of the locations
    check_targets_match(got, jax_targets(loc, st, rg, gts, spec), loc, gts, spec,
                        allowed=max(1, got["gt_inds"].size // 1000))


# the hand cases of tests/test_targets.py: (gts, classes, spec changes)
_BOX = [20.0, 20, 60, 20, 60, 60, 20, 60]
HAND_CASES = {
    "single_box": ([_BOX], [2], {}),
    "min_area_tie_break": ([[10.0, 10, 70, 10, 70, 70, 10, 70], [28.0, 28, 52, 28, 52, 52, 28, 52]],
                           [1, 2], {}),
    "level_filter_big_box": ([[10.0, 10, 110, 10, 110, 110, 10, 110]], [0], {}),
    "rotated_diamond": ([[40.0, 20, 60, 40, 40, 60, 20, 40]], [1], {}),
    "invalid_gt": ([_BOX], [1], {"valid": False}),
    "equal_area_tie": ([_BOX, [22.0, 22, 58, 22, 58, 58, 22, 58], [30.0, 20, 70, 20, 70, 60, 30, 60]],
                       [0, 1, 2], {}),
    "empty_image": ([], [], {}),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_cases_match_jax(case):
    boxes, classes, opts = HAND_CASES[case]
    spec = AssignmentSpec(**TWO_LEVELS)
    loc, st, rg = tables((128, 128), spec)
    m = 8
    gts = dict(gt_corners=np.zeros((1, m, 8), np.float32), gt_hbox=np.zeros((1, m, 4), np.float32),
               gt_classes=np.zeros((1, m), np.int32), gt_area=np.zeros((1, m), np.float32),
               gt_valid=np.zeros((1, m), bool))
    for i, (c, cl) in enumerate(zip(boxes, classes)):
        c = np.asarray(c, np.float32)
        gts["gt_corners"][0, i] = c
        gts["gt_hbox"][0, i] = [c[0::2].min(), c[1::2].min(), c[0::2].max(), c[1::2].max()]
        gts["gt_area"][0, i] = np.asarray(jq.quad_area(jnp.asarray(c)))
        gts["gt_classes"][0, i] = cl
        gts["gt_valid"][0, i] = opts.get("valid", True)
    keys = ("gt_corners", "gt_hbox", "gt_classes", "gt_area", "gt_valid")
    got = assign_targets_single(*map(torch.from_numpy, (loc, st, rg)),
                                *(torch.from_numpy(gts[k][0]) for k in keys), spec)
    got = {k: v.numpy()[None] for k, v in got.items()}
    want = jax_assign_targets_single(loc, st, rg, *(gts[k][0] for k in keys),
                                     JaxSpec(**{**_fields(spec), "impl": "xla"}))
    want = {k: np.asarray(v)[None] for k, v in want.items()}
    for key in ("labels", "gt_inds"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("reg_corners", "reg_ltrb", "reg_abcd"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    center = np.where((loc[:, 0] == 36) & (loc[:, 1] == 36))[0][0]
    pos = got["labels"][0] != spec.num_classes
    if case in ("invalid_gt", "empty_image"):
        assert not pos.any() and (got["gt_inds"] == -1).all()
    elif case == "min_area_tie_break":
        assert got["gt_inds"][0, center] == 1  # the smaller box wins
    elif case == "level_filter_big_box":
        assert pos[16 * 16:].any()  # level-1 positives
    else:
        assert pos[center]


# the flag variants of tests/test_golden_torch.py::TestFullAssignmentGolden,
# with its allowance: gts up to 120 px have areas near 1.4e4, where one f32
# ulp of the area (~1e-3) is the in-quad test's whole epsilon, so without
# center sampling whole interiors are ambiguous (10 of 1364 locations
# differ in "no_center_sample"); each difference must be ambiguous in
# float64, and at most 1% of the locations may differ
FLAG_CASES = {
    "default_small": (7, 0, {}),
    "default_many": (77, 1, {}),
    "no_center_sample": (12, 2, {"center_sample": False}),
    "center_sample_only": (12, 3, {"center_sample_only": True}),
    "quad_only": (12, 4, {"combine_center_sample": False}),
    "no_level_filter": (12, 5, {"enable_level_size_filtering": False}),
    "no_in_box_check": (12, 6, {"enable_in_box_check": False}),
    "no_stride_norm": (12, 7, {"enable_fpn_stride_norm": False}),
    "radius_0.75": (12, 8, {"pos_radius": 0.75}),
    "radius_3": (12, 9, {"pos_radius": 3.0}),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_flag_variants_match_jax(case):
    m, seed, flags = FLAG_CASES[case]
    spec = AssignmentSpec(num_classes=15, **{"pos_radius": 1.5, **flags})
    loc, st, rg = tables((256, 256), spec)
    rng = np.random.RandomState(seed)
    gts = packed_gts(rng, 1, m, n_max=None, num_classes=15, lo=40.0, hi=216.0, size=(6.0, 120.0))
    got = port_targets(loc, st, rg, gts, spec)
    check_targets_match(got, jax_targets(loc, st, rg, gts, spec), loc, gts, spec,
                        allowed=max(3, got["gt_inds"].size // 100))
