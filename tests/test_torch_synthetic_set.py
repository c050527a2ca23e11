"""The cv2-drawn synthetic set of the port against the JAX package's.

``data/raster.py::fill_poly`` against ``cv2.fillPoly`` (random, degenerate
and rotated-rectangle polygons inside the image; a vertex outside
refused), ``load_synthetic`` against ``dafne_tpu/data/datasets/
synthetic.py::load_synthetic`` for every split at full count (pixels and
annotations), the registration and metadata, DEBUG.OVERFIT_NUM_IMAGES,
and one loader batch of ``configs/synthetic/base.yaml`` (its 90-degree
rotations) equal to the JAX loader's.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import get_dataset as jax_get_dataset
from dafne_tpu.data.datasets import synthetic as JS
from dafne_tpu.data.loader import DataLoader as JaxDataLoader
from dafne_tpu.data.mapper import pad_target_hw as jax_pad_target_hw
from dafne_tpu.data.registry import MetadataCatalog as JaxMetadata
from dafne_tpu.data.registry import register_all_datasets as jax_register_all

from dafne_torch.config import get_cfg
from dafne_torch.data import get_dataset, register_all_datasets
from dafne_torch.data import synthetic as S
from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import pad_target_hw
from dafne_torch.data.raster import fill_poly, line_pixels
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "synthetic", "base.yaml")


def _fill_both(pts, shape=(64, 80, 3), color=(200, 100, 50)):
    a = np.zeros(shape, np.uint8)
    b = a.copy()
    cv2.fillPoly(a, [np.asarray(pts, np.int32)], color)
    fill_poly(b, np.asarray(pts, np.int32), color)
    return a, b


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_equals_cv2_on_random_polygons(seed):
    rng = np.random.RandomState(seed)
    for _ in range(400):
        m = rng.randint(1, 9)  # 1 and 2 vertices too; self-crossing polygons included
        pts = np.stack([rng.randint(0, 80, m), rng.randint(0, 64, m)], 1)
        a, b = _fill_both(pts)
        np.testing.assert_array_equal(b, a, err_msg=str(pts.tolist()))


def test_fill_poly_equals_cv2_on_degenerate_polygons_and_gray():
    for pts in ([[5, 5], [5, 5], [5, 5]], [[3, 3], [20, 3], [40, 3]], [[3, 3], [3, 30], [3, 50]],
                [[0, 0], [79, 63]], [[10, 10]], [[5, 5], [30, 30], [5, 5], [30, 30]],
                [[0, 0], [79, 0], [79, 63], [0, 63]], [[40, 0], [41, 63], [39, 63]]):
        a, b = _fill_both(pts)
        np.testing.assert_array_equal(b, a, err_msg=str(pts))
        a, b = _fill_both(pts, shape=(64, 80), color=(77,))
        np.testing.assert_array_equal(b, a, err_msg=str(pts))


def test_line_pixels_equal_cv2_line():
    rng = np.random.RandomState(5)
    for _ in range(300):
        p, q = rng.randint(0, 64, 2), rng.randint(0, 64, 2)
        a = np.zeros((64, 64), np.uint8)
        cv2.line(a, tuple(map(int, p)), tuple(map(int, q)), 255, 1, cv2.LINE_8)
        b = np.zeros_like(a)
        xs, ys = line_pixels(p, q)
        b[ys, xs] = 255
        np.testing.assert_array_equal(b, a)


def test_fill_poly_equals_cv2_on_the_sets_own_quads():
    """Rotated rectangles drawn as ``_make_record`` draws them, on 256^2."""
    rng = np.random.RandomState(11)
    for _ in range(600):
        cx, cy = rng.uniform(40, 216, 2)
        w, h, ang = rng.uniform(20, 60), rng.uniform(12, 40), rng.uniform(0, np.pi)
        quad = S._rot_rect(cx, cy, w, h, ang).astype(np.int32)
        a, b = _fill_both(quad, shape=(256, 256, 3), color=[int(rng.randint(255))] * 3)
        np.testing.assert_array_equal(b, a)


def test_fill_poly_refuses_a_vertex_outside_the_image():
    with pytest.raises(NotImplementedError, match="outside"):
        fill_poly(np.zeros((10, 10, 3), np.uint8), np.array([[1, 1], [12, 3], [4, 8]]), (1, 2, 3))
    with pytest.raises(NotImplementedError, match="outside"):
        fill_poly(np.zeros((10, 10, 3), np.uint8), np.array([[1, -1], [5, 3], [4, 8]]), (1, 2, 3))


@pytest.mark.parametrize("split,n", [("train", 64), ("val", 16), ("test", 16)])
def test_load_synthetic_equals_jax(split, n):
    ours, theirs = S.load_synthetic(split, n), JS.load_synthetic(split, n)
    assert len(ours) == len(theirs) == n
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got["image"], want["image"], err_msg=want["image_id"])
        assert {k: v for k, v in got.items() if k != "image"} == \
            {k: v for k, v in want.items() if k != "image"}


def test_registration_and_overfit_equal_jax():
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_file(RECIPE)
    cfg.merge_from_file(RECIPE)
    jax_register_all(jcfg)
    register_all_datasets(cfg)
    for split in ("train", "val", "test"):
        name = f"synthetic_{split}"
        assert MetadataCatalog[name] == JaxMetadata[name]
        assert MetadataCatalog[name]["thing_classes"] == S.CLASSES == JS.CLASSES
    assert len(DatasetCatalog.get("synthetic_train")) == 64
    for c in (jcfg, cfg):
        c.merge_from_list(["DEBUG.OVERFIT_NUM_IMAGES", "32"])
    ours, theirs = get_dataset("synthetic_train", cfg), jax_get_dataset("synthetic_train", jcfg)
    assert len(ours) == len(theirs) == 32
    assert [r["image_id"] for r in ours] == [r["image_id"] for r in theirs]
    assert len(DatasetCatalog.get("synthetic_val", 5)) == 5  # sized: only the first five made


def test_recipe_loader_batch_equals_jax():
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_file(RECIPE)
        c.merge_from_list(["DATALOADER.NUM_WORKERS", "2", "DEBUG.OVERFIT_NUM_IMAGES", "32"])
    assert cfg.INPUT.ROTATION_AUG_ANGLES == [0.0, 90.0, 180.0, 270.0]
    jax_register_all(jcfg)
    register_all_datasets(cfg)
    pad = pad_target_hw(cfg, train=True)
    assert pad == tuple(jax_pad_target_hw(jcfg, train=True)) == (256, 256)
    records, jrecords = get_dataset("synthetic_train", cfg), jax_get_dataset("synthetic_train", jcfg)
    b = cfg.SOLVER.IMS_PER_BATCH
    ours = iter(DataLoader(cfg, records, b, seed=3, pad_hw=pad))
    theirs = iter(JaxDataLoader(jcfg, jrecords, b, train=True, seed=3, pad_hw=pad))
    try:
        for _ in range(2):
            got, want = next(ours), next(theirs)
            assert got["image"].shape == (b, 256, 256, 3)
            np.testing.assert_array_equal(got["image"].numpy(), want["image"])
            for key in GT_KEYS:
                np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("name", ["synthetic_val", "synthetic_gen_val"])
def test_overfit_off_keeps_every_record(name):
    """DEBUG.OVERFIT_NUM_IMAGES -1 (the default: off) gives a generator set
    every record, as JAX's registry does (the port's once gave none)."""
    jcfg, cfg = jax_get_cfg(), get_cfg()
    assert cfg.DEBUG.OVERFIT_NUM_IMAGES == jcfg.DEBUG.OVERFIT_NUM_IMAGES == -1
    jax_register_all(jcfg)
    register_all_datasets(cfg)
    want = jax_get_dataset(name, jcfg)
    got = get_dataset(name, cfg)
    assert len(got) == len(want) > 0
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
