"""The dataset families read from disk, port vs JAX: DOTA (1.0 and 1.5),
HRSC2016, UCAS-AOD and ICDAR15 records, and their registered names and
metadata.

Each test writes a tree in the dataset's own layout (the DOTA devkit's
tiles and COCO json, HRSC's XML, the UCAS-AOD and ICDAR15 text files) and
loads it through both packages.  Tolerance: none; records are equal as
Python objects (the same float64 arithmetic on the same parsed values).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import mapper as JM
from dafne_tpu.data.datasets import dota as jax_dota
from dafne_tpu.data.datasets import hrsc2016 as jax_hrsc
from dafne_tpu.data.datasets import icdar15 as jax_icdar
from dafne_tpu.data.datasets import ucas_aod as jax_ucas
from dafne_tpu.data.registry import DatasetCatalog as JaxDatasetCatalog
from dafne_tpu.data.registry import MetadataCatalog as JaxMetadataCatalog
from dafne_tpu.data.registry import register_all_datasets as jax_register_all

from dafne_torch.config import get_cfg
from dafne_torch.data import mapper as M
from dafne_torch.data.datasets import dota, hrsc2016, icdar15, ucas_aod
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog, register_all_datasets
from dafne_torch.data.synthetic import load_synthetic_gen

from chip_smoke import write_dota_tree

torch.set_num_threads(1)

FAMILIES = ("dota_", "hrsc_", "ucas_aod_", "icdar15_")


def _cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(list(extra))
    return jcfg, cfg


# ---------------------------------------------------------------------- DOTA


@pytest.fixture(scope="module")
def dota_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dota"))
    train = load_synthetic_gen("train", 4, hw=64, max_boxes=6)
    val = load_synthetic_gen("val", 3, hw=64, max_boxes=6)
    originals = [r["image"] for r in load_synthetic_gen("test", 2, hw=114, max_boxes=4)]
    info = write_dota_tree(root, train, val, originals, 64, 50, np.random.RandomState(0))
    return root, info


def _split_paths(root, version, split):
    d = os.path.join(root, f"dota_{version}_split", f"{split}1024")
    return os.path.join(d, f"DOTA{version}_{split}1024.json"), os.path.join(d, "images")


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("mini", [False, True])
def test_dota_records_equal_jax(dota_tree, split, mini):
    root, info = dota_tree
    jcfg, cfg = _cfgs()
    jf, ir = _split_paths(root, "1", split)
    got = dota.load_dota_json(jf, ir, cfg, mini=mini)
    assert got == jax_dota.load_dota_json(jf, ir, jcfg, mini=mini)
    if not mini:  # the planted skips: area, side, degenerate quad, 6-value polygon
        kept, dropped = info["counts"][split]
        n_json = len(json.load(open(jf)).get("annotations", []))
        assert sum(len(r["annotations"]) for r in got) == kept == n_json - dropped
    else:
        assert len(got) == 10  # 5% of a few tiles, at least 10, drawn with replacement
    assert all(os.path.exists(r["file_name"]) for r in got)


@pytest.mark.parametrize("remove", [False, True])
def test_dota_15_container_crane(dota_tree, remove):
    root, info = dota_tree
    jcfg, cfg = _cfgs(["DATASETS.DOTA_REMOVE_CONTAINER_CRANE", str(remove)])
    jf, ir = _split_paths(root, "1_5", "train")
    got = dota.load_dota_json(jf, ir, cfg)
    assert got == jax_dota.load_dota_json(jf, ir, jcfg)
    scene, cranes = info["crane"]
    labels = [a["category_id"] for r in got for a in r["annotations"]]
    assert len(labels) == scene + (0 if remove else cranes)
    assert labels.count(15) == (0 if remove else cranes)


@pytest.mark.parametrize("extra", [[], ["INPUT.MIN_AREA", "1000"], ["INPUT.MIN_SIDE", "40"],
                                   ["INPUT.MIN_AREA", "0", "INPUT.MIN_SIDE", "0"]])
def test_dota_skips_follow_min_area_and_min_side(tmp_path, extra):
    """A hand-written json: unsorted category ids, polygons of odd and
    short lengths before the quad, a missing segmentation and area, a
    difficult flag, corners within and just past 1e-2 of each other."""
    doc = {
        "images": [{"id": 7, "file_name": "a.png", "height": 64, "width": 80},
                   {"id": 3, "file_name": "b.png", "height": 64, "width": 64}],
        "categories": [{"id": 9, "name": "ship"}, {"id": 2, "name": "plane"},
                       {"id": 5, "name": "harbor"}],
        "annotations": [
            {"image_id": 7, "category_id": 9, "bbox": [1, 2, 30, 40], "difficult": 1,
             "segmentation": [[1, 2, 3], [1, 2, 31, 2, 31, 42], [1, 2, 31, 2, 31, 42, 1, 42]]},
            {"image_id": 7, "category_id": 2, "bbox": [5, 5, 20, 20], "area": 400,
             "segmentation": [[5, 5, 25, 5, 25, 25, 5, 25, 5, 5]]},
            {"image_id": 7, "category_id": 5, "bbox": [0, 0, 3, 3], "segmentation": []},
            {"image_id": 3, "category_id": 2, "bbox": [0, 0, 50, 50],
             "segmentation": [[0, 0, 0.009, 0, 50, 50, 0, 50]]},
            {"image_id": 3, "category_id": 5, "bbox": [0, 0, 50, 50],
             "segmentation": [[0, 0, 0.011, 0, 50, 50, 0, 50]]},
            {"image_id": 3, "category_id": 9, "bbox": [10, 10, 1.5, 30], "area": 45,
             "segmentation": [[10, 10, 11.5, 10, 11.5, 40, 10, 40]]},
        ],
    }
    path = tmp_path / "d.json"
    path.write_text(json.dumps(doc))
    jcfg, cfg = _cfgs(extra)
    got = dota.load_dota_json(str(path), str(tmp_path), cfg)
    assert got == jax_dota.load_dota_json(str(path), str(tmp_path), jcfg)
    assert [r["image_id"] for r in got] == ["a", "b"]


def test_dota_devkit_tiles_load_and_map_like_jax(tmp_path):
    """A raw scene through the repo's devkit tiler (128^2 tiles, gap 28):
    the records and the train and eval examples mapped from the decoded
    tiles equal JAX's."""
    from tools.prepare_dota.split_dota import prepare

    raw = tmp_path / "raw"
    rng = np.random.RandomState(3)
    for split in ("train", "val"):
        os.makedirs(raw / split / "images")
        os.makedirs(raw / split / "labelTxt")
        cv2.imwrite(str(raw / split / "images" / "P0001.png"),
                    rng.randint(0, 255, (200, 230, 3)).astype(np.uint8))
        (raw / split / "labelTxt" / "P0001.txt").write_text(
            "imagesource:GoogleEarth\ngsd:0.1\n"
            "10 10 60 10 60 40 10 40 ship 0\n"
            "150 120 200 125 195 170 145 165 plane 1\n"
            "80 80 80 80 90 95 80 95 harbor 0\n")
    prepare(str(raw), str(tmp_path / "dota_1_split"), patch_size=128, overlap=28, workers=1)
    jf = str(tmp_path / "dota_1_split" / "train128" / "DOTA1_train128.json")
    ir = str(tmp_path / "dota_1_split" / "train128" / "images")
    jcfg, cfg = _cfgs(["INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128",
                       "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "128",
                       "TPU.MAX_INSTANCES", "8"])
    records = dota.load_dota_json(jf, ir, cfg)
    assert records == jax_dota.load_dota_json(jf, ir, jcfg)
    assert len(records) == 6  # x in (0, 100, 102), y in (0, 72)
    for train in (True, False):
        ours = M.DatasetMapper(cfg, (128, 128), train=train)
        theirs = JM.DatasetMapper(jcfg, train, (128, 128))
        for i, r in enumerate(records):
            got, want = ours(r, np.random.RandomState(i)), theirs(r, np.random.RandomState(i))
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_mapper_crops_like_jax_when_a_record_understates_its_size(tmp_path, caplog):
    """A record whose height and width are smaller than its file: JAX
    renders at the file's size and crops to the canvas with one warning;
    so does the port."""
    path = str(tmp_path / "big.png")
    cv2.imwrite(path, np.random.RandomState(0).randint(0, 255, (96, 80, 3)).astype(np.uint8))
    record = {"file_name": path, "image_id": "big", "height": 64, "width": 64,
              "annotations": []}
    jcfg, cfg = _cfgs(["INPUT.MIN_SIZE_TEST", "80", "INPUT.MAX_SIZE_TEST", "96"])  # unit scale
    got = M.DatasetMapper(cfg, (64, 64), train=False)(record)
    want = JM.DatasetMapper(jcfg, False, (64, 64))(record)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert "exceeds the static canvas" in caplog.text


# ------------------------------------------------------------ HRSC, UCAS, ICDAR


def _hrsc_tree(root):
    os.makedirs(root / "ImageSets")
    os.makedirs(root / "labelXml")
    (root / "ImageSets" / "trainval.txt").write_text("100000001\n100000002\n\n")
    for img_id, objs in ((100000001, [(200.5, 150.25, 100, 40, 0.5, 0),
                                      (400, 300, 60, 20, -1.2, 1)]),
                         (100000002, [(50, 60, 30, 10, 3.0, 0)])):
        body = "".join(
            f"<HRSC_Object><mbox_cx>{cx}</mbox_cx><mbox_cy>{cy}</mbox_cy><mbox_w>{w}</mbox_w>"
            f"<mbox_h>{h}</mbox_h><mbox_ang>{a}</mbox_ang><difficult>{d}</difficult></HRSC_Object>"
            for cx, cy, w, h, a, d in objs)
        (root / "labelXml" / f"{img_id}.xml").write_text(
            f"<HRSC_Image><Img_SizeWidth>1100</Img_SizeWidth><Img_SizeHeight>600</Img_SizeHeight>"
            f"<HRSC_Objects>{body}</HRSC_Objects></HRSC_Image>")


def test_hrsc_records_equal_jax(tmp_path):
    _hrsc_tree(tmp_path)
    got = hrsc2016.load_hrsc(str(tmp_path), "trainval")
    assert got == jax_hrsc.load_hrsc(str(tmp_path), "trainval") and len(got) == 2
    np.testing.assert_array_equal(hrsc2016.xywha_to_corners(1, 2, 3, 4, 0.7),
                                  jax_hrsc.xywha_to_corners(1, 2, 3, 4, 0.7))


@pytest.mark.parametrize("ext_writer", ["png-cv2", "png-palette", "bmp"])
def test_ucas_aod_records_equal_jax(tmp_path, ext_writer):
    """Sizes from the file header (the port) and from PIL (JAX) agree; the
    image itself must be a PNG under AllImages."""
    root = tmp_path / "UCAS-AOD"
    os.makedirs(root / "ImageSets")
    os.makedirs(root / "Annotations")
    os.makedirs(root / "AllImages")
    img = np.random.RandomState(1).randint(0, 255, (48, 70, 3)).astype(np.uint8)
    for stem in ("P0001", "0002"):
        path = str(root / "AllImages" / f"{stem}.png")
        if ext_writer == "png-palette":
            from PIL import Image

            Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=16).save(path)
        else:
            cv2.imwrite(path, img)
        (root / "Annotations" / f"{stem}.txt").write_text(
            "car 10 10 50 10 50 30 10 30\n"
            "airplane 100 100 160 100 160 140 100 140\n"
            "__background__ 0 0 5 0 5 5 0 5\n"
            "car 200 200 201 200 201 201 200 201\n"
            "car 300 300 400 300 400 301 300 301\n")
    (root / "ImageSets" / "train.txt").write_text("P0001\n0002\n")
    got = ucas_aod.load_ucas_aod(str(root), "train")
    assert got == jax_ucas.load_ucas_aod(str(root), "train")
    assert [(r["width"], r["height"], r["image_id"]) for r in got] == [(70, 48, "0001"),
                                                                      (70, 48, "0002")]


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_icdar15_records_equal_jax(tmp_path, split):
    """JPEG sizes from the SOF marker; val reads the train folder."""
    root = tmp_path / "icdar-2015"
    os.makedirs(root / "ImageSets")
    folder = "test" if split == "test" else "train"
    os.makedirs(root / "Annotations" / folder)
    os.makedirs(root / "images" / folder)
    for i, (w, h) in enumerate(((1280, 720), (97, 61))):
        img = np.random.RandomState(i).randint(0, 255, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(root / "images" / folder / f"img_{i + 1}.jpg"), img)
        (root / "Annotations" / folder / f"gt_img_{i + 1}.txt").write_bytes(
            "﻿".encode() + b"10,10,60,12,58,40,9,38,HELLO\n"
            b"100,100,150,100,150,130,100,130,###\n5,5,6,5,6,6,5,6,tiny\n")
    (root / "ImageSets" / f"{split}.txt").write_text("gt_img_1\ngt_img_2\n")
    got = icdar15.load_icdar15(str(root), split)
    assert got == jax_icdar.load_icdar15(str(root), split)
    assert [(r["width"], r["height"]) for r in got] == [(1280, 720), (97, 61)]


# ------------------------------------------------------------------ registry


@pytest.mark.parametrize("remove_cc", [False, True])
def test_registered_names_and_metadata_equal_jax(tmp_path, monkeypatch, remove_cc):
    monkeypatch.setenv("DAFNE_DATA_DIR", str(tmp_path))
    jcfg, cfg = _cfgs(["DATASETS.DOTA_REMOVE_CONTAINER_CRANE", str(remove_cc)])
    register_all_datasets(cfg)
    jax_register_all(jcfg)
    ours = [n for n in DatasetCatalog.list() if n.startswith(FAMILIES)]
    theirs = [n for n in JaxDatasetCatalog.list() if n.startswith(FAMILIES)]
    assert ours == theirs and len(ours) == 2 * 2 * 3 * 6 + 4 + 4 + 3
    for name in ours:
        assert MetadataCatalog[name] == JaxMetadataCatalog[name], name
    assert MetadataCatalog["dota_1_5_val_600"]["thing_classes"][-1] == (
        "helicopter" if remove_cc else "container-crane")
    assert MetadataCatalog["hrsc_test"]["root_dir"] == os.path.join(str(tmp_path), "hrsc")


def test_registered_dota_loads_the_tree(dota_tree, monkeypatch):
    root, info = dota_tree
    monkeypatch.setenv("DAFNE_DATA_DIR", root)
    jcfg, cfg = _cfgs()
    register_all_datasets(cfg)
    jax_register_all(jcfg)
    for name in ("dota_1_train_1024", "dota_1_val_1024_mini", "dota_1_test_1024"):
        got = DatasetCatalog.get(name)
        assert got == JaxDatasetCatalog.get(name) and got
    assert MetadataCatalog["dota_1_test_1024"]["is_test"]
    assert not any(r["annotations"] for r in DatasetCatalog.get("dota_1_test_1024"))
