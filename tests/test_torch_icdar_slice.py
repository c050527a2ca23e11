"""The ICDAR-2015 recipes on a tiny JPEG tree, port against JAX.

An ICDAR-2015 tree of JPEGs written here with cv2 (``chip_smoke.
write_icdar15_tree``: text lines as dark rotated quads, "###" on the
unreadable ones, a line 1 pixel wide the loader drops) under
DAFNE_DATA_DIR.  Then:

- the port's records of every split equal the JAX loader's (which reads
  sizes with PIL), "###" lines difficult;
- the loader's train batches of ``configs/icdar15/base.yaml`` and the eval
  examples equal the JAX package's byte for byte (its mapper decodes with
  ``cv2.imread``);
- the CLI with ``--config-file configs/icdar15/base.yaml`` at a narrow
  width and small sizes takes 2 train steps from the JPEGs, then
  ``--eval-only`` with the recipe's TTA (flip) on a cut ladder;
- ``configs/icdar15/r101.yaml`` loads and its model builds.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import get_dataset as jax_get_dataset
from dafne_tpu.data.loader import DataLoader as JaxDataLoader
from dafne_tpu.data.mapper import DatasetMapper as JaxDatasetMapper
from dafne_tpu.data.registry import register_all_datasets as jax_register_all

from dafne_torch.config import get_cfg
from dafne_torch.data import get_dataset, register_all_datasets
from dafne_torch.data import jpeg as J
from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import DatasetMapper, eval_pad_hw
from dafne_torch.models import build_model
from dafne_torch.tools.train import main as cli_main

from chip_smoke import write_icdar15_tree
from test_torch_model import NARROW

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "configs", "icdar15", "base.yaml")
R101 = os.path.join(ROOT, "configs", "icdar15", "r101.yaml")
SMALL = ["INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "160",
         "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160", "TPU.MAX_INSTANCES", "16"]
SIZES = ((160, 96), (97, 131), (150, 100), (128, 72))  # (width, height)


def _image(w, h, rng):
    """A noisy gradient with dark rotated text lines; (JPEG bytes, words)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 2 + y) % 256, 128 + 0 * x, (y * 3) % 256], -1).astype(np.float64)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    words = []
    for k in range(3):
        cx, cy = rng.uniform(0.3 * w, 0.7 * w), rng.uniform(0.25 * h, 0.75 * h)
        a, b, t = rng.uniform(20, 40), rng.uniform(6, 10), rng.uniform(-0.3, 0.3)
        quad = np.array([[-a, -b], [a, -b], [a, b], [-a, b]]) @ np.array(
            [[np.cos(t), np.sin(t)], [-np.sin(t), np.cos(t)]]) + [cx, cy]
        pts = np.round(quad).astype(np.int32)
        cv2.fillPoly(img, [pts], (20, 20, 30))
        words.append((pts.reshape(8).tolist(), "###" if k == 2 else f"word{k}"))
    ok, data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85,
                                          cv2.IMWRITE_JPEG_PROGRESSIVE, int(w % 2)])
    return data.tobytes(), words


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("icdar_slice")
    rng = np.random.RandomState(15)
    images = [_image(w, h, rng) for w, h in SIZES]
    ids = write_icdar15_tree(str(root / "data" / "icdar-2015"), {
        "train": images[:2], "val": images[2:3], "test": [images[3], images[0]]})
    return str(root / "data"), ids


@pytest.fixture
def data_root(tree, monkeypatch):
    data, ids = tree
    monkeypatch.setenv("DAFNE_DATA_DIR", data)
    return ids


def _cfgs(recipe=BASE, extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_file(recipe)
        c.merge_from_list([str(v) for v in list(NARROW) + SMALL + list(extra)])
    return jcfg, cfg


def test_records_equal_jax(data_root):
    jcfg, cfg = _cfgs()
    register_all_datasets(cfg)
    jax_register_all(jcfg)
    for split, n in (("train", 2), ("val", 1), ("test", 2)):
        ours = get_dataset(f"icdar15_{split}", cfg)
        theirs = jax_get_dataset(f"icdar15_{split}", jcfg)
        assert ours == theirs and len(ours) == n
        for r in ours:
            assert [a["difficult"] for a in r["annotations"]] == [False, False, True]  # 1-px line dropped
    assert {r["image_id"] for r in get_dataset("icdar15_val", cfg)} == {"3"}


def test_train_batches_and_eval_examples_equal_jax(data_root):
    jcfg, cfg = _cfgs(extra=["DATALOADER.NUM_WORKERS", "2"])
    register_all_datasets(cfg)
    jax_register_all(jcfg)
    records = get_dataset("icdar15_train", cfg) + get_dataset("icdar15_val", cfg)
    jrecords = jax_get_dataset("icdar15_train", jcfg) + jax_get_dataset("icdar15_val", jcfg)
    J.reset_launch_counts()
    ours = iter(DataLoader(cfg, records, 2, seed=5, pad_hw=(256, 256)))
    theirs = iter(JaxDataLoader(jcfg, jrecords, 2, train=True, seed=5, pad_hw=(256, 256)))
    try:
        for _ in range(3):
            got, want = next(ours), next(theirs)
            np.testing.assert_array_equal(got["image"].numpy(), want["image"])
            for key in GT_KEYS:
                np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    finally:
        ours.close()
        theirs.close()
    assert J.decode.launches >= 6  # the JPEGs were decoded by the library
    test = get_dataset("icdar15_test", cfg)
    pad = eval_pad_hw(cfg, test)
    mapper, jmapper = DatasetMapper(cfg, pad, train=False), JaxDatasetMapper(jcfg, False, pad)
    for rec, jrec in zip(test, jax_get_dataset("icdar15_test", jcfg)):
        got, want = mapper(rec), jmapper(jrec)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_cli_trains_and_evaluates_with_tta(data_root, tmp_path):
    args = ["--config-file", BASE] + [str(v) for v in NARROW] + SMALL + [
        "SOLVER.REFERENCE_WORLD_SIZE", "0", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
        "SOLVER.WARMUP_ITERS", "0", "TPU.EVAL_BATCH", "2", "TPU.NMS_MAX_CANDIDATES", "128",
        "TPU.NMS_GROUP_CANDIDATES", "32", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "64",
        "TEST.AUG.MIN_SIZES", "(64, 96)", "TEST.AUG.MAX_SIZE", "160",
        "OUTPUT_DIR", str(tmp_path / "run")]
    train_stats = {}
    results = cli_main(args + ["TEST.AUG.ENABLED", "False"], device="cpu", train_stats=train_stats)
    losses = [x for v in train_stats["steps"].values() for x in v["loss"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert np.isfinite(results["icdar15_test"]["mAP"])
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "last_checkpoint")
    stats, tta_stats = {}, {}
    results = cli_main(["--eval-only"] + args, device="cpu", stats=stats, tta_stats=tta_stats)
    assert stats["icdar15_test"]["images"] == 2
    per = tta_stats["icdar15_test"]["per_image"]
    assert len(per) == 2 and all(p["copies"] == 6 for p in per)  # 2 sizes x (identity, hflip, vflip)
    assert np.isfinite(results["tta"]["icdar15_test"]["mAP"])


def test_both_recipes_build():
    for recipe, depth in ((BASE, 50), (R101, 101)):
        cfg = get_cfg()
        cfg.merge_from_file(recipe)
        cfg.merge_from_list([str(v) for v in NARROW])
        assert cfg.MODEL.RESNETS.DEPTH == depth and cfg.MODEL.DAFNE.NUM_CLASSES == 1
        assert cfg.TEST.DETECTIONS_PER_IMAGE == 2000 and len(cfg.TEST.AUG.MIN_SIZES) == 9
        model = build_model(cfg, device="cpu")
        n_blocks = sum(1 for name, _ in model.named_modules()
                       if name.startswith("backbone.res4_") and name.count(".") == 1)
        assert n_blocks == (6 if depth == 50 else 23)
