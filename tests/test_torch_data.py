"""Port's train data path vs the JAX package: transforms, mapper, samplers,
loader.

Records are the port's numpy synthetic scenes (square, 128^2); the config
is the DOTA recipe's augmentation (hflip, vflip, rotations by 0/90/180/270)
at a unit-scale resize.  The same records and RandomState seeds go through
both packages; gt arrays and images must be equal.
"""

import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import transforms as JT
from dafne_tpu.data.loader import DataLoader as JaxDataLoader
from dafne_tpu.data.loader import build_sampler as jax_build_sampler
from dafne_tpu.data.mapper import DatasetMapper as JaxMapper

from dafne_torch.config import get_cfg
from dafne_torch.data import transforms as T
from dafne_torch.data.loader import GT_KEYS, DataLoader, build_sampler
from dafne_torch.data.mapper import DatasetMapper
from dafne_torch.data.synthetic import load_synthetic_gen

torch.set_num_threads(1)

RECIPE = ["INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128", "TPU.MAX_INSTANCES",
          "16", "DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
          "DATALOADER.REPEAT_THRESHOLD", "0.2"]


def cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(RECIPE + list(extra))
    return jcfg, cfg


@pytest.fixture(scope="module")
def records():
    return load_synthetic_gen("train", 6, hw=128, max_boxes=12)


@pytest.mark.parametrize("color", [False, True])
def test_mapper_matches_jax(records, color):
    jcfg, cfg = cfgs(["INPUT.USE_COLOR_AUGMENTATIONS", str(color)])
    ours, theirs = DatasetMapper(cfg, (128, 128)), JaxMapper(jcfg, True, (128, 128))
    draws = set()
    for seed in range(16):
        rec = records[seed % len(records)]
        got = ours(rec, np.random.RandomState(seed))
        want = theirs(rec, np.random.RandomState(seed))
        for key in GT_KEYS + ("gt_difficult",):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["gt_valid"].any()
        aug = T.build_train_augmentations(cfg, 128, 128, np.random.RandomState(seed))
        draws.add(tuple(np.round(aug.matrix[:, :2]).ravel()))
    assert len(draws) >= 6  # flips and rotations were both drawn


def test_transforms_match_jax():
    jcfg, cfg = cfgs()
    for seed in range(8):
        got = T.build_train_augmentations(cfg, 96, 160, np.random.RandomState(seed))
        want = JT.build_train_augmentations(jcfg, 96, 160, np.random.RandomState(seed))
        np.testing.assert_array_equal(got.matrix, want.matrix)
        assert (got.out_w, got.out_h) == (want.out_w, want.out_h)
    pts = np.random.RandomState(0).uniform(0, 100, (5, 4, 2))
    for make in ("hflip", "vflip"):
        got, want = getattr(T, make)(100, 80), getattr(JT, make)(100, 80)
        np.testing.assert_array_equal(got.apply_coords(pts), want.apply_coords(pts))
    np.testing.assert_array_equal(T.rotation(64, 64, 90).matrix, JT.rotation(64, 64, 90).matrix)
    np.testing.assert_array_equal(T.shortest_edge_resize(300, 200, 128, 160).matrix,
                                  JT.shortest_edge_resize(300, 200, 128, 160).matrix)
    img = np.random.RandomState(1).randint(0, 255, (32, 32, 3)).astype(np.uint8)
    for angle in (90, 180, 270):
        aug = T.hflip(32, 32).compose(T.rotation(32, 32, angle))
        np.testing.assert_array_equal(aug.apply_image(img), JT.AffineAug(
            aug.matrix, 32, 32).apply_image(img))
    # a general angle and a resize, which need cv2's warp and resize
    for aug in (T.rotation(32, 32, 30), T.resize(32, 32, 64, 64)):
        np.testing.assert_array_equal(aug.apply_image(img), JT.AffineAug(
            aug.matrix, aug.out_w, aug.out_h).apply_image(img))
    np.testing.assert_array_equal(
        T.apply_color_augmentations(img, np.random.RandomState(3)),
        JT.apply_color_augmentations(img, np.random.RandomState(3)))


@pytest.mark.parametrize("sampler", ["TrainingSampler", "RepeatFactorTrainingSampler"])
def test_sampler_stream_matches_jax(records, sampler):
    jcfg, cfg = cfgs(["DATALOADER.SAMPLER_TRAIN", sampler])
    ours, theirs = build_sampler(cfg, records, seed=5), jax_build_sampler(jcfg, records, seed=5)
    got = [next(ours) for _ in range(200)]
    assert got == [next(theirs) for _ in range(200)]
    if sampler == "RepeatFactorTrainingSampler":
        assert len(got) > len(set(got))


def test_loader_batches_match_jax(records):
    jcfg, cfg = cfgs(["DATALOADER.NUM_WORKERS", "2"])
    ours = iter(DataLoader(cfg, records, 3, seed=2, pad_hw=(128, 128)))
    theirs = iter(JaxDataLoader(jcfg, records, 3, train=True, seed=2, pad_hw=(128, 128)))
    try:
        for _ in range(3):
            got, want = next(ours), next(theirs)
            assert got["image"].dtype == torch.uint8 and got["image"].shape == (3, 128, 128, 3)
            np.testing.assert_array_equal(got["image"].numpy(), want["image"])
            for key in GT_KEYS:
                np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    finally:
        ours.close()
        theirs.close()
