"""The data-from-disk slice as a whole, port vs JAX, on a narrow DOTA tree.

A DOTA tree of 128^2 PNG tiles in the devkit's layout (``chip_smoke.
write_dota_tree``: 4 train tiles, 3 val tiles, 8 test tiles cut from 2
originals at stride 100) and one synthetic Detectron2 ``.pth`` for the
narrow R-50, imported into both packages.  Then:

- ``--eval-only`` on the labeled val split through the port's CLI against
  the JAX package's ``do_test``: at least 99% of JAX's detections matched
  (score within 1e-4, corners within 1e-2, as ``tests/test_torch_eval.py``
  holds them) and every AP within 0.1;
- ``--eval-only`` on the unlabeled test split: ``task1/``,
  ``task1_merged/`` and ``submission.zip``, the merged files byte-equal to
  what the JAX package's ``merge_by_poly`` makes of the port's own Task1
  files;
- a 3-step ``do_train`` from the files equal, parameter for parameter, to
  the same records given with their images decoded in memory, a
  device-aug batch from the files equal to the in-memory one, and TTA
  from the files equal to TTA from the decoded images.
"""

import os
import zipfile

import numpy as np
import pytest
import torch

import dafne_tpu.engine.train_loop as jax_train_loop
from dafne_tpu.data import get_dataset as jax_get_dataset
from dafne_tpu.data.mapper import DatasetMapper as JaxDatasetMapper
from dafne_tpu.data.registry import register_all_datasets as jax_register_all
from dafne_tpu.evaluation import result_merge as JR
from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.utils.weight_import import load_reference_weights as jax_load_reference_weights

import dafne_torch.engine.train_loop as train_loop
from dafne_torch.data import get_dataset, register_all_datasets
from dafne_torch.data.image_io import read_image
from dafne_torch.data.loader import DataLoader
from dafne_torch.data.mapper import DatasetMapper, device_aug_base_hw
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog
from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine.checkpoint import load_weights
from dafne_torch.engine.tta import do_test_with_tta
from dafne_torch.models import build_model
from dafne_torch.tools.train import main as cli_main

from chip_smoke import (DOTA_10_CLASSES, match_rate, reference_values, write_dota_tree,
                        write_reference_checkpoints)
from test_torch_eval import UNIT_128, _capture_evaluators
from test_torch_model import NARROW, narrow_cfgs, random_flax_params

torch.set_num_threads(2)

EVAL = UNIT_128 + [
    "MODEL.DAFNE.NUM_CLASSES", "15", "TPU.EVAL_BATCH", "4", "TPU.NMS_GROUP_CANDIDATES", "64",
    "TPU.NMS_MAX_CANDIDATES", "256", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "300",
    "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100", "TEST.NUM_PRED_VIS", "0",
    "DATALOADER.NUM_WORKERS", "2"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("files_slice")
    data = str(root / "data")
    train = load_synthetic_gen("train", 4, hw=128, max_boxes=8)
    val = load_synthetic_gen("val", 3, hw=128, max_boxes=8)
    originals = [r["image"] for r in load_synthetic_gen("test", 2, hw=228, max_boxes=8)]
    write_dota_tree(data, train, val, originals, 128, 100, np.random.RandomState(0))
    _, tcfg = narrow_cfgs(["MODEL.DAFNE.NUM_CLASSES", "15"])
    values = reference_values(build_model(tcfg, device="cpu").state_dict(),
                              np.random.RandomState(1))
    _, pth = write_reference_checkpoints(values, str(root / "weights"))
    return root, data, pth


@pytest.fixture
def data_root(tree, monkeypatch):
    root, data, pth = tree
    monkeypatch.setenv("DAFNE_DATA_DIR", data)
    return root, pth


def _args(out, pth, test_set):
    return [str(v) for v in NARROW] + EVAL + [
        "OUTPUT_DIR", str(out), "MODEL.WEIGHTS", pth, "DATASETS.TEST", f"('{test_set}',)"]


def test_eval_on_val_files_matches_jax(data_root, monkeypatch):
    root, pth = data_root
    name = "dota_1_val_1024"
    stats = {}
    got = cli_main(["--eval-only"] + _args(root / "port_val", pth, name), device="cpu",
                   stats=stats)[name]

    jcfg, _ = narrow_cfgs(EVAL + ["DATASETS.TEST", f"('{name}',)"])
    jax_register_all(jcfg)
    jmodel = jax_build_model(jcfg)
    params = jax_load_reference_weights(pth, random_flax_params(jmodel, seed=2, hw=128))
    made = _capture_evaluators(monkeypatch, jax_train_loop)
    want = jax_train_loop.do_test(jcfg, jmodel, params, str(root / "jax_val"))[name]

    matched, total = match_rate(stats[name]["preds"], made[name]._preds)
    assert stats[name]["images"] == 3 and total >= 150, total
    assert matched >= 0.99 * total, (matched, total)
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 0.1, key


def test_eval_on_the_unlabeled_test_split_writes_the_submission(data_root):
    root, pth = data_root
    name = "dota_1_test_1024"
    out = root / "port_test"
    stats = {}
    assert cli_main(["--eval-only"] + _args(out, pth, name), device="cpu",
                    stats=stats)[name] == {}  # no AP without annotations
    inference = out / "inference" / name
    task1, merged = inference / "task1", inference / "task1_merged"
    files = sorted(f"Task1_{c}.txt" for c in DOTA_10_CLASSES)
    assert sorted(os.listdir(task1)) == sorted(os.listdir(merged)) == files
    assert stats[name]["images"] == 8 and {"task1_s", "merge_s", "zip_s"} <= set(stats[name])
    tiles = {line.split()[0] for f in files for line in open(task1 / f)}
    assert len(tiles) == 8 and all("__1__" in t for t in tiles)
    originals = {line.split()[0] for f in files for line in open(merged / f)}
    assert originals == {"P0001", "P0002"}

    JR.merge_by_poly(str(task1), str(out / "jax_merged"), num_workers=1)
    for f in files:
        assert (merged / f).read_bytes() == (out / "jax_merged" / f).read_bytes(), f
    with zipfile.ZipFile(inference / "submission.zip") as z:
        assert z.namelist() == files
        assert all(z.read(f) == (merged / f).read_bytes() for f in files)
    assert not (out / "test_results.csv").exists()


def test_train_from_files_equals_in_memory_images(data_root):
    root, pth = data_root
    _, cfg = narrow_cfgs(UNIT_128 + [
        "MODEL.DAFNE.NUM_CLASSES", "15", "INPUT.MIN_SIZE_TRAIN", "(128,)",
        "INPUT.MAX_SIZE_TRAIN", "128", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "3",
        "SOLVER.CHECKPOINT_PERIOD", "0", "TEST.EVAL_PERIOD", "0", "TPU.MAX_INSTANCES", "32",
        "DATALOADER.NUM_WORKERS", "2", "MODEL.WEIGHTS", pth])
    register_all_datasets(cfg)
    files = get_dataset("dota_1_train_1024", cfg)
    assert all("image" not in r for r in files)
    in_memory = [dict(r, image=read_image(r["file_name"])) for r in files]
    states, metrics = [], []
    for i, records in enumerate((files, in_memory)):
        cfg.OUTPUT_DIR = str(root / f"train_{i}")
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        metrics.append(train_loop.do_train(cfg, model, records))
        states.append(model.state_dict())
    losses = [{k: v for k, v in m.items() if k.startswith("loss/")} for m in metrics]
    assert losses[0] == losses[1] and losses[0]["loss/total"] > 0
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_device_aug_batches_from_files_equal_in_memory_images(data_root):
    """TPU.TRAIN_DEVICE_AUG: the base canvas takes its size from the
    records' height and width (no decode), and a batch of decoded base
    images equals the one made from in-memory images."""
    _, cfg = narrow_cfgs(["INPUT.MIN_SIZE_TRAIN", "(96, 128)", "INPUT.MAX_SIZE_TRAIN", "128",
                          "TPU.MAX_INSTANCES", "32", "DATALOADER.NUM_WORKERS", "2"])
    register_all_datasets(cfg)
    files = get_dataset("dota_1_train_1024", cfg)
    assert device_aug_base_hw(files) == (128, 128)
    in_memory = [dict(r, image=read_image(r["file_name"])) for r in files]
    idx, seeds = [0, 1, 2, 3], [5, 6, 7, 8]
    got, want = (DataLoader(cfg, recs, 4, pad_hw=(128, 128), device_aug=True).make_batch(idx, seeds)
                 for recs in (files, in_memory))
    assert set(got) == set(want) and "image_base" in got
    for key in got:
        if key != "image_id":
            assert torch.equal(got[key], want[key]), key


def test_tta_from_files_equals_in_memory_images(data_root):
    root, pth = data_root
    _, cfg = narrow_cfgs(EVAL + ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(128, 256)",
                                 "TEST.AUG.MAX_SIZE", "256"])
    register_all_datasets(cfg)
    files = get_dataset("dota_1_val_1024", cfg)[:2]
    DatasetCatalog.register("files_tta_memory",
                            lambda: [dict(r, image=read_image(r["file_name"])) for r in files])
    MetadataCatalog["files_tta_memory"] = MetadataCatalog["dota_1_val_1024"]
    DatasetCatalog.register("files_tta_files", lambda: files)
    MetadataCatalog["files_tta_files"] = MetadataCatalog["dota_1_val_1024"]
    model = build_model(cfg, device="cpu")
    load_weights(model, pth)
    cfg.DATASETS.TEST = ["files_tta_files", "files_tta_memory"]
    stats = {}
    results = do_test_with_tta(cfg, model, stats=stats)
    assert results["files_tta_files"] == results["files_tta_memory"]
    got, want = stats["files_tta_files"]["preds"], stats["files_tta_memory"]["preds"]
    assert list(got) == list(want) == [r["image_id"] for r in files]
    for image_id in want:
        for key in want[image_id]:
            np.testing.assert_array_equal(got[image_id][key], want[image_id][key])


@pytest.mark.parametrize("cache", [False, True])
def test_cache_images_keeps_the_decoded_image_like_jax(data_root, cache):
    """DATALOADER.CACHE_IMAGES: mapping a file record decodes it and, when
    on, leaves the image on the record, as JAX's mapper does; the example
    is the same on the first and the second mapping."""
    jcfg, cfg = narrow_cfgs(EVAL + ["DATALOADER.CACHE_IMAGES", str(cache)])
    jax_register_all(jcfg)
    register_all_datasets(cfg)
    want = jax_get_dataset("dota_1_val_1024", jcfg)[0]
    got = get_dataset("dota_1_val_1024", cfg)[0]
    jmapper = JaxDatasetMapper(jcfg, train=False, pad_hw=(128, 128))
    mapper = DatasetMapper(cfg, pad_hw=(128, 128), train=False)
    jax_first = jmapper(want)
    first = mapper(got)
    second = mapper(got)
    assert ("image" in got) == ("image" in want) == cache
    if cache:
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["image"], read_image(got["file_name"]))
    np.testing.assert_array_equal(first["image"], jax_first["image"])
    for key in first:
        np.testing.assert_array_equal(first[key], second[key])
