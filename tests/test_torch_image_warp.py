"""The host warp library (``csrc/image_warp.cpp``, ``data/image_warp.py``)
and its plain NumPy version against cv2, and the port's
``AffineAug.apply_image`` against the JAX package's.

cv2 is the reference: ``cv2.resize`` and ``cv2.warpAffine`` with
``INTER_LINEAR`` on uint8 BGR images, as ``dafne_tpu/data/transforms.py``
calls them.  Every case must be bit-equal (0 difference) for the library
and for the plain version: up and down scales, non-uniform scales, an exact
2x downscale (which cv2 hands to INTER_AREA), 1 x N and N x 1 images, the
HRSC2016 image sizes under the shortest-edge resizes of the recipe's
ladder, and rotations by 30, 45, 60 and 123.4 degrees composed with
resizes and flips.  Then every map the train augmentation of the HRSC
multi-scale recipe and the TTA copies with a 30-degree angle draw renders
equal to the JAX package's.
"""

import cv2
import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import transforms as JT
from dafne_tpu.engine import tta as JTTA

from dafne_torch.config import get_cfg
from dafne_torch.data import image_warp as IW
from dafne_torch.data import transforms as T
from dafne_torch.engine import tta

torch.set_num_threads(1)

# (width, height) of HRSC2016 images: the dataset's sizes run from about
# 300 x 300 to 1500 x 900
HRSC_SIZES = [(1166, 753), (1280, 800), (500, 333), (300, 300)]
# hrsc_r50_ms.yaml's train and TTA ladder, cut to its ends and middle
HRSC_RECIPE = ["INPUT.MIN_SIZE_TRAIN", "(320, 800, 1520)", "INPUT.MAX_SIZE_TRAIN", "1520",
               "INPUT.MIN_SIZE_TEST", "800", "INPUT.MAX_SIZE_TEST", "1333",
               "INPUT.ROTATION_AUG_ANGLES", "(0.0, 30.0, 60.0, 90.0, 120.0, 150.0)"]


def _image(h, w, seed, c=3):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)).astype(np.uint8)


def _pixel_matrix(aug):
    """The cv2 image matrix of an AffineAug, as the JAX package builds it."""
    lin = aug.matrix[:, :2]
    return np.hstack([lin, (lin @ np.array([0.5, 0.5]) + aug.matrix[:, 2] - 0.5)[:, None]]
                     ).astype(np.float32)


RESIZES = [  # (src h, src w, dst h, dst w)
    (300, 500, 640, 1067), (600, 1000, 450, 750), (97, 131, 60, 263), (240, 160, 100, 400),
    (1000, 600, 500, 300), (1, 50, 1, 77), (50, 1, 77, 1), (1, 40, 3, 20), (1, 1, 5, 5),
    (7, 9, 3, 2),
] + [(h, w, a.out_h, a.out_w) for w, h in HRSC_SIZES for s in (320, 800, 1520)
     for a in [T.shortest_edge_resize(w, h, s, 1520)]]


@pytest.mark.parametrize("sh,sw,dh,dw", RESIZES)
def test_resize_equals_cv2(sh, sw, dh, dw):
    img = _image(sh, sw, sh * 7 + sw)
    want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(IW.resize_linear(img, dw, dh), want)
    np.testing.assert_array_equal(IW.resize_linear_plain(img, dw, dh), want)


def _warp_cases():
    cases = []
    for i, angle in enumerate((30.0, 45.0, 60.0, 123.4)):
        for w, h in ((97, 131), (523, 300), (1166, 753)):
            aug = T.identity(w, h)
            if i % 2:
                aug = aug.compose(T.hflip(w, h))
            if i >= 2:
                aug = aug.compose(T.vflip(w, h))
            aug = aug.compose(T.rotation(w, h, angle))
            size = {97: 160, 523: 200, 1166: 320}[w]  # up, down and the ladder's smallest
            cases.append((angle, w, h, aug.compose(T.shortest_edge_resize(w, h, size, 1520))))
    return cases


@pytest.mark.parametrize("angle,w,h,aug", _warp_cases(),
                         ids=[f"{a}-{w}x{h}" for a, w, h, _ in _warp_cases()])
def test_warp_affine_equals_cv2(angle, w, h, aug):
    img = _image(h, w, int(angle * 10) + w)
    m = _pixel_matrix(aug)
    want = cv2.warpAffine(img, m, (aug.out_w, aug.out_h), flags=cv2.INTER_LINEAR)
    assert want.any() and not want.all()  # the corners fall outside the source
    np.testing.assert_array_equal(IW.warp_affine_linear(img, m, aug.out_w, aug.out_h), want)
    np.testing.assert_array_equal(IW.warp_affine_linear_plain(img, m, aug.out_w, aug.out_h),
                                  want)


def test_warp_rows_of_every_length_equal_cv2():
    """Row lengths 1 to 40: every split of a row into the 16-pixel SIMD part
    and the scalar tail, and one-pixel sources, at a 30-degree angle."""
    for w in range(1, 41):
        h = 1 + (w * 7) % 23
        img = _image(h, w, w)
        aug = T.rotation(w, h, 30.0).compose(T.resize(w, h, w + 3, h))
        m = _pixel_matrix(aug)
        want = cv2.warpAffine(img, m, (aug.out_w, aug.out_h), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(IW.warp_affine_linear(img, m, aug.out_w, aug.out_h), want)
        np.testing.assert_array_equal(
            IW.warp_affine_linear_plain(img, m, aug.out_w, aug.out_h), want)


def test_fma_f32_rounds_once():
    """The plain version's fused multiply-add: one rounding of the exact
    a * b + c, also where the double sum falls on a float32 midpoint."""
    a = np.float32(1 + 2.0 ** -12)
    b = np.float32(1 + 2.0 ** -12)
    c = np.float32(-1)
    # exact: 2^-11 + 2^-24, a float32; the float32 product alone rounds it away
    assert IW.fma_f32(a, b, c) == np.float32(2.0 ** -11 + 2.0 ** -24)
    assert np.float32(a * b) + c != IW.fma_f32(a, b, c)
    # a*b = 2^-24 (1 - 2^-46): the exact sum lies just below the float32
    # midpoint c + 2^-24, but its double is that midpoint, which rounds to
    # even (1 + 2^-22); rounded once, it is c
    a, b, c = (np.float32(v) for v in (2.0 ** -24 * (1 + 2.0 ** -23), 1 - 2.0 ** -23,
                                        1 + 2.0 ** -23))
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert twice == np.float32(1 + 2.0 ** -22)
    assert IW.fma_f32(a, b, c) == c
    rng = np.random.RandomState(0)
    p, q, r = (rng.uniform(-300, 300, 4000).astype(np.float32) for _ in range(3))
    near = (p.astype(np.float64) * q + r).astype(np.float32)  # off only at midpoints
    np.testing.assert_array_equal(IW.fma_f32(p, q, r), near)


def test_library_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="uint8"):
        IW.resize_linear(np.zeros((4, 4, 3), np.float32), 2, 2)
    with pytest.raises(ValueError, match="empty"):
        IW.warp_affine_linear(np.zeros((0, 4, 3), np.uint8), np.eye(2, 3), 2, 2)
    with pytest.raises(ValueError, match="uint8"):
        T.rotation(4, 4, 30.0).apply_image(np.zeros((4, 4, 3), np.float32))


def test_launch_counts():
    IW.reset_launch_counts()
    img = _image(20, 30, 0)
    T.resize(30, 20, 40, 10).apply_image(img)
    T.rotation(30, 20, 45.0).apply_image(img)
    T.hflip(30, 20).apply_image(img)  # a flip: no library call
    assert (IW.resize_linear.launches, IW.warp_affine_linear.launches) == (1, 1)


def _cfgs(extra):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(HRSC_RECIPE + list(extra))
    return jcfg, cfg


@pytest.mark.parametrize("w,h", HRSC_SIZES[:3])
def test_train_maps_render_as_jax(w, h):
    """The maps ``build_train_augmentations`` draws for the HRSC recipe
    (flips, the six angles, each ladder scale forced as the bucketed loader
    forces it): the port's image equals the JAX package's."""
    jcfg, cfg = _cfgs([])
    img = _image(h, w, w)
    drawn = set()
    for seed in range(12):
        size = (320, 800, 1520)[seed % 3]
        aug = T.build_train_augmentations(cfg, w, h, np.random.RandomState(seed), size)
        jaug = JT.build_train_augmentations(jcfg, w, h, np.random.RandomState(seed), size)
        np.testing.assert_array_equal(aug.matrix, jaug.matrix)
        np.testing.assert_array_equal(aug.apply_image(img), jaug.apply_image(img))
        drawn.add(aug._axis_aligned_fast(img) is None)
    assert drawn == {True, False}  # both the warp and the axis-aligned path ran


def test_tta_copies_render_as_jax():
    """Every TTA copy of a non-square image with a 30-degree angle, flips
    and three scales, as ``tta_inference_single``'s host path renders it."""
    jcfg, cfg = _cfgs(["TEST.AUG.MIN_SIZES", "(320, 640, 800)", "TEST.AUG.MAX_SIZE", "1333",
                       "TEST.AUG.ROTATION_ANGLES", "(30.0,)"])
    w, h = 523, 300
    img = _image(h, w, 5)
    augs, jaugs = tta.build_tta_augs(cfg, w, h), JTTA.build_tta_augs(jcfg, w, h)
    assert len(augs) == len(jaugs) == 9
    for aug, jaug in zip(augs, jaugs):
        np.testing.assert_array_equal(aug.apply_image(img), jaug.apply_image(img))
    _, flips = _cfgs(["TEST.AUG.MIN_SIZES", "(320, 640)", "TEST.AUG.MAX_SIZE", "1333"])
    for aug in tta.build_tta_augs(flips, w, h):
        np.testing.assert_array_equal(aug.apply_image(img),
                                      JT.AffineAug(aug.matrix, aug.out_w, aug.out_h
                                                   ).apply_image(img))
