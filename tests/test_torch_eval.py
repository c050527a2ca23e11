"""The evaluation path, port vs JAX: polygon IoU, the VOC-07 evaluator, the
dataset registry, the eval mapper and loader, do_test end to end, the
checkpointer and the train/eval CLI.

Inputs are made from seeds with numpy.  Scenes are the port's numpy
renderings; where both packages must see the same pixels, the same records
are registered under one name in both catalogs.
"""

import json
import os

import numpy as np
import pytest
import torch

import dafne_tpu.engine.train_loop as jax_train_loop
from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import mapper as JM
from dafne_tpu.data import transforms as JT
from dafne_tpu.data.loader import DataLoader as JaxDataLoader
from dafne_tpu.data.registry import DatasetCatalog as JaxDatasetCatalog
from dafne_tpu.data.registry import MetadataCatalog as JaxMetadataCatalog
from dafne_tpu.data.registry import register_all_datasets as jax_register_all
from dafne_tpu.evaluation import voc_eval as JV
from dafne_tpu.evaluation.evaluator import RotatedDetectionEvaluator as JaxEvaluator
from dafne_tpu.models import build_model as jax_build_model
from dafne_tpu.utils import polyiou as jax_polyiou
from dafne_tpu.utils import polyiou_np as jax_polyiou_np

import dafne_torch.engine.train_loop as train_loop
from dafne_torch.config import get_cfg
from dafne_torch.data import get_dataset, register_all_datasets
from dafne_torch.data import mapper as M
from dafne_torch.data import transforms as T
from dafne_torch.data.loader import DataLoader
from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog
from dafne_torch.data.synthetic import GEN_CLASSES, load_synthetic_gen
from dafne_torch.engine.checkpoint import Checkpointer
from dafne_torch.engine.optimizer import build_optimizer
from dafne_torch.engine.trainer import make_train_step
from dafne_torch.evaluation import voc_eval as V
from dafne_torch.evaluation.evaluator import RotatedDetectionEvaluator
from dafne_torch.models import build_model
from dafne_torch.tools.train import main as cli_main
from dafne_torch.utils import polyiou

from chip_smoke import match_rate
from test_torch_model import NARROW, narrow_cfgs, port_model_from, random_flax_params
from test_torch_quad_nms import _random_boxes

torch.set_num_threads(1)

AP_TOL = 1e-9  # APs: the same float64 arithmetic on both sides
UNIT_128 = ["INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "128"]


# ---------------------------------------------------------------- polygon IoU


def test_polyiou_equals_jax():
    rng = np.random.RandomState(0)
    p = _random_boxes(300, seed=1, extent=80.0).astype(np.float64)
    q = np.concatenate([p[:150] + rng.uniform(-3, 3, (150, 8)), _random_boxes(150, 2, 80.0)])
    np.testing.assert_array_equal(polyiou.iou_poly_pairs(p, q), jax_polyiou_np.iou_pairs(p, q))
    np.testing.assert_array_equal(polyiou.iou_matrix(p[:20], q[:30]),
                                  jax_polyiou_np.iou_matrix(p[:20], q[:30]))
    scores = rng.rand(300)
    keep = polyiou.poly_nms(q[:200], scores[:200], 0.1)
    np.testing.assert_array_equal(keep, jax_polyiou.poly_nms(q[:200], scores[:200], 0.1))
    assert 0 < keep.sum() < 200


# ------------------------------------------------------------------ evaluator


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_equals_jax(use_07):
    rng = np.random.RandomState(int(use_07))
    for _ in range(20):
        tp = (rng.rand(50) < rng.rand()).astype(float)
        rec = np.cumsum(tp) / max(tp.sum() + rng.randint(0, 5), 1)
        prec = np.cumsum(tp) / np.arange(1, 51)
        assert abs(V.voc_ap(rec, prec, use_07) - JV.voc_ap(rec, prec, use_07)) <= AP_TOL


def _eval_scene(seed, n_images=6, n_classes=3):
    """Records with rotated gts (some difficult), one image listed twice, and
    detections: jittered gts (a few far off), wrong-class copies and false
    positives, with tied scores."""
    rng = np.random.RandomState(seed)
    records, dets = [], {}
    for i in range(n_images):
        n = rng.randint(2, 9)
        gts = _random_boxes(n, seed=seed * 100 + i, extent=200.0).astype(np.float64)
        cls = rng.randint(0, n_classes, n)
        annos = [{"corners": g.tolist(), "category_id": int(c), "difficult": bool(rng.rand() < 0.15)}
                 for g, c in zip(gts, cls)]
        records.append({"image_id": f"img{i}", "height": 256, "width": 256, "annotations": annos})
        jitter = rng.uniform(-1, 1, gts.shape) * rng.choice([1.0, 12.0], (n, 1), p=[0.8, 0.2])
        fps = _random_boxes(4, seed=seed * 100 + 50 + i, extent=200.0)
        corners = np.concatenate([gts + jitter, gts[:2] + 0.5, fps])
        classes = np.concatenate([cls, (cls[:2] + 1) % n_classes, rng.randint(0, n_classes, 4)])
        scores = np.round(rng.rand(len(corners)) * 10) / 10
        dets[f"img{i}"] = (corners.astype(np.float32), scores.astype(np.float32),
                           classes.astype(np.int32), np.ones(len(corners), bool))
    records.append(dict(records[0]))  # a duplicated record: its gts count once
    return records, dets


def _assert_scores_overlap_close(got, want):
    """[confidence, overlap, is_tp(, class)] rows: equal, the overlap within
    1e-9 (the JAX package takes it from its C++ polygon IoU where g++ built
    it, the port from the NumPy one)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and list(g[2:]) == list(w[2:]) and abs(g[1] - w[1]) <= AP_TOL


def test_eval_class_equals_jax():
    records, dets = _eval_scene(3)
    gt_by_image = {}
    ids, scores, corners = [], [], []
    for r in records:
        g = [a for a in r["annotations"] if a["category_id"] == 1]
        if g:
            gt_by_image[r["image_id"]] = (np.asarray([a["corners"] for a in g]),
                                          np.asarray([a["difficult"] for a in g]))
        c, s, k, _ = dets[r["image_id"]]
        ids += [r["image_id"]] * int((k == 1).sum())
        scores.append(s[k == 1])
        corners.append(c[k == 1])
    scores, corners = np.concatenate(scores), np.concatenate(corners)
    got = V.eval_class(ids, scores, corners, gt_by_image, 0.5, True)
    want = JV.eval_class(ids, scores, corners, gt_by_image, 0.5, True)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=AP_TOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=AP_TOL)
    assert abs(got[2] - want[2]) <= AP_TOL and 0 < got[2] < 1
    _assert_scores_overlap_close(got[3], want[3])
    np.testing.assert_array_equal(V._hbb(corners), JV._hbb(corners))


def test_evaluator_equals_jax(tmp_path):
    """Per-class APs and mAP within 1e-9; results.txt, scores_overlap.csv
    and every Task1 line identical."""
    records, dets = _eval_scene(7)
    names = ["plane", "ship", "tank"]
    ours = RotatedDetectionEvaluator("toy", records, names, output_dir=str(tmp_path / "port"))
    theirs = JaxEvaluator("toy", records, names, output_dir=str(tmp_path / "jax"))
    ids = sorted(dets)
    for ev in (ours, theirs):
        # through process_batch, with a padded slot that must be skipped
        for start in range(0, len(ids), 4):
            chunk = ids[start:start + 4]
            chunk += [chunk[-1]] * (4 - len(chunk))
            k = max(len(dets[i][0]) for i in chunk)
            batch = {"image_id": chunk, "batch_valid": np.arange(4) < len(set(chunk))}
            decoded = {key: np.zeros((4, k) + shape, dtype)
                       for key, shape, dtype in (("corners", (8,), np.float32), ("scores", (), np.float32),
                                                 ("classes", (), np.int32), ("valid", (), bool))}
            for slot, i in enumerate(chunk):
                for key, v in zip(("corners", "scores", "classes", "valid"), dets[i]):
                    decoded[key][slot, :len(v)] = v
            ev.process_batch(batch, decoded)
    got, want = ours.evaluate(), theirs.evaluate()
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= AP_TOL, key
    assert 0 < got["mAP"] < 100
    for rel in ["results.txt"] + [f"task1/Task1_{n}.txt" for n in names]:
        a = (tmp_path / "port" / rel).read_text()
        assert a and a == (tmp_path / "jax" / rel).read_text(), rel
    rows = [(tmp_path / side / "scores_overlap.csv").read_text().splitlines() for side in ("port", "jax")]
    assert rows[0][0] == rows[1][0] == "confidence,overlap,is_tp,class"
    _assert_scores_overlap_close(*[[[float(v) if k < 3 else v for k, v in enumerate(r.split(","))]
                                    for r in side[1:]] for side in rows])


# ------------------------------------------------------------------- datasets


def test_registry_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DAFNE_DATA_DIR", str(tmp_path))  # an empty data root
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(["DEBUG.OVERFIT_NUM_IMAGES", "3"])
    jcfg.merge_from_list(["DEBUG.OVERFIT_NUM_IMAGES", "3"])
    register_all_datasets(cfg)
    jax_register_all(jcfg)
    for prefix in ("synthetic_gen", "synthetic_gen1024"):
        for split in ("train", "val", "test"):
            name = f"{prefix}_{split}"
            assert name in DatasetCatalog and MetadataCatalog[name] == JaxMetadataCatalog[name]
    got, want = get_dataset("synthetic_gen_val", cfg), JaxDatasetCatalog.get("synthetic_gen_val")[:3]
    assert len(got) == 3 and [r["image_id"] for r in got] == [r["image_id"] for r in want]
    for r, w in zip(got, want):
        assert r["annotations"] == w["annotations"] and r["image"].shape == w["image"].shape
    # the file families are registered too; with no tree under the data
    # root, loading one raises
    assert MetadataCatalog["dota_1_val_1024"] == JaxMetadataCatalog["dota_1_val_1024"]
    with pytest.raises(FileNotFoundError):
        get_dataset("dota_1_val_1024")


@pytest.fixture(scope="module")
def records128():
    return load_synthetic_gen("val", 5, hw=128, max_boxes=8)


def _data_cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(UNIT_128 + ["TPU.MAX_INSTANCES", "16"] + list(extra))
    return jcfg, cfg


def test_eval_mapper_matches_jax(records128):
    jcfg, cfg = _data_cfgs()
    ours = M.DatasetMapper(cfg, (128, 128), train=False)
    theirs = JM.DatasetMapper(jcfg, False, (128, 128))
    for rec in records128:
        got, want = ours(rec), theirs(rec)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # a test-time resize (down, and up onto a larger canvas) renders as cv2's
    for size, pad in ((96, 128), (200, 256)):
        jresized, resized = _data_cfgs(["INPUT.MIN_SIZE_TEST", str(size), "INPUT.MAX_SIZE_TEST",
                                        str(pad)])
        ours = M.DatasetMapper(resized, (pad, pad), train=False)
        theirs = JM.DatasetMapper(jresized, False, (pad, pad))
        for rec in records128[:2]:
            got, want = ours(rec), theirs(rec)
            assert tuple(got["resized_hw"]) == (size, size)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_eval_pad_hw_and_test_augmentation_match_jax():
    sized = [{"width": 300, "height": 200}, {"width": 150, "height": 400}]
    with_image = [{"image": np.zeros((90, 120, 3), np.uint8)}]
    for extra in (["INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "256"],
                  ["INPUT.RESIZE_TYPE", "both", "INPUT.RESIZE_WIDTH_TEST", "200",
                   "INPUT.RESIZE_HEIGHT_TEST", "100"]):
        jcfg, cfg = _data_cfgs(extra)
        for recs in (sized, with_image, sized + [{}]):
            assert M.eval_pad_hw(cfg, recs) == JM.eval_pad_hw(jcfg, recs), (extra, recs)
        for w, h in ((300, 200), (128, 128), (77, 333)):
            a, b = T.build_test_augmentation(cfg, w, h), JT.build_test_augmentation(jcfg, w, h)
            np.testing.assert_array_equal(a.matrix, b.matrix)
            assert (a.out_w, a.out_h) == (b.out_w, b.out_h)


def test_eval_loader_matches_jax(records128):
    """Sequential batches in record order, the last padded with repeats:
    images, image ids, batch_valid, scales and gts equal."""
    jcfg, cfg = _data_cfgs(["DATALOADER.NUM_WORKERS", "2"])
    ours = DataLoader(cfg, records128, 2, pad_hw=(128, 128), train=False)
    theirs = JaxDataLoader(jcfg, records128, 2, train=False, pad_hw=(128, 128))
    assert len(ours) == len(theirs) == 3
    got, want = list(ours), list(theirs)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"]
        np.testing.assert_array_equal(g["batch_valid"], w["batch_valid"])
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        for key in ("scale_xy", "orig_hw", "resized_hw", "gt_corners", "gt_valid"):
            np.testing.assert_array_equal(g[key].numpy(), w[key], err_msg=key)
    assert got[-1]["batch_valid"].tolist() == [True, False]
    with pytest.raises(TypeError):
        len(DataLoader(cfg, records128, 2, pad_hw=(128, 128)))


# -------------------------------------------------------------------- do_test


def _capture_evaluators(monkeypatch, module):
    """Keep each evaluator that `module.do_test` builds, to read its
    per-image detections."""
    made = {}
    build = module.build_evaluator

    def keep(cfg, name, records, out_dir=None):
        made[name] = build(cfg, name, records, out_dir)
        return made[name]

    monkeypatch.setattr(module, "build_evaluator", keep)
    return made


def test_do_test_end_to_end_matches_jax(tmp_path, monkeypatch, records128):
    """The narrow R-50 with the same weights on 5 scenes at 128^2, eval
    batch 2 so that the last batch is padded (the JAX side rounds the batch
    up to its 8-device mesh; detections are compared per image id), grouped
    NMS with K = 64.  Model outputs agree to
    ~1e-5, not bit for bit, so a near-tie may swap at a top-k boundary: at
    least 99% of JAX's detections matched, and the mAP within 0.1."""
    name = "torch_eval_gen128"
    recs = records128
    for catalog in (DatasetCatalog, JaxDatasetCatalog):
        catalog.register(name, lambda: recs)
    meta = {"evaluator_type": "synthetic", "thing_classes": GEN_CLASSES, "is_test": False}
    MetadataCatalog[name], JaxMetadataCatalog[name] = dict(meta), dict(meta)
    jcfg, tcfg = narrow_cfgs(UNIT_128 + [
        "DATASETS.TEST", f"('{name}',)", "TPU.EVAL_BATCH", "2", "TPU.NMS_GROUP_CANDIDATES", "64",
        "TPU.NMS_MAX_CANDIDATES", "256", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "300",
        "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100", "MODEL.DAFNE.NUM_CLASSES", "6",
        "TEST.NUM_PRED_VIS", "0", "DATALOADER.NUM_WORKERS", "0"])
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=31, hw=128)

    jax_made = _capture_evaluators(monkeypatch, jax_train_loop)
    want = jax_train_loop.do_test(jcfg, jmodel, params, str(tmp_path / "jax"))[name]
    stats = {}
    got = train_loop.do_test(tcfg, port_model_from(params, tcfg), str(tmp_path / "port"),
                             stats=stats)[name]

    port_preds = stats[name]["preds"]
    assert stats[name]["images"] == len(recs) and stats[name]["loop_s"] > 0
    assert sorted(port_preds) == sorted(jax_made[name]._preds) == sorted(
        r["image_id"] for r in recs)
    matched, total = match_rate(port_preds, jax_made[name]._preds)
    assert total >= 300, total
    assert matched >= 0.99 * total, (matched, total)
    assert list(got) == list(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 0.1, key
    out = tmp_path / "port"
    assert (out / "inference" / name / "results.txt").exists()
    assert (out / "test_results.csv").read_text().startswith("iteration,dataset,metric,value")


# ----------------------------------------------------------- checkpoint, CLI


def test_checkpoint_save_and_resume(tmp_path):
    _, cfg = narrow_cfgs(["SOLVER.WARMUP_ITERS", "0", "INPUT.MIN_SIZE_TRAIN", "(128,)",
                          "INPUT.MAX_SIZE_TRAIN", "128"])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).train()
    optimizer, scheduler = build_optimizer(cfg, model)
    mapper = M.DatasetMapper(cfg, (128, 128))
    recs = load_synthetic_gen("train", 2, hw=128, max_boxes=6)
    ex = [mapper(r, np.random.RandomState(i)) for i, r in enumerate(recs)]
    batch = {k: torch.from_numpy(np.stack([e[k] for e in ex]))
             for k in ("image", "gt_corners", "gt_hbox", "gt_classes", "gt_area", "gt_valid")}
    make_train_step(model, cfg, (128, 128), optimizer, scheduler)(batch)  # momentum, LR step

    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ck.latest_step() is None
    for step in (1, 2, 3):
        ck.save(step, model, optimizer, scheduler)
    assert ck.latest_step() == 3
    assert sorted(os.listdir(ck.dir)) == ["last_checkpoint", "model_0000002.pth", "model_0000003.pth"]

    other = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    opt2, sched2 = build_optimizer(cfg, other)
    assert ck.resume_or_load(other, cfg, resume=False, optimizer=opt2, scheduler=sched2) == 0
    assert not torch.equal(other.state_dict()["head.cls_logits.weight"],
                           model.state_dict()["head.cls_logits.weight"])
    assert ck.resume_or_load(other, cfg, resume=True, optimizer=opt2, scheduler=sched2) == 3
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert opt2.state_dict()["param_groups"] == optimizer.state_dict()["param_groups"]
    for i, st in optimizer.state_dict()["state"].items():
        assert torch.equal(opt2.state_dict()["state"][i]["momentum_buffer"], st["momentum_buffer"])
    assert sched2.state_dict() == scheduler.state_dict()

    # no checkpoint to resume: MODEL.WEIGHTS, a bare state dict, is loaded
    weights = tmp_path / "weights.pth"
    torch.save(model.state_dict(), weights)
    cfg.MODEL.WEIGHTS = str(weights)
    fresh = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert Checkpointer(str(tmp_path / "empty")).resume_or_load(fresh, cfg, resume=True) == 0
    assert torch.equal(fresh.state_dict()["head.cls_logits.weight"],
                       model.state_dict()["head.cls_logits.weight"])


def _cli_args(tmp_path, name):
    return [str(v) for v in NARROW] + UNIT_128 + [
        "OUTPUT_DIR", str(tmp_path), "DATASETS.TRAIN", f"('{name}',)",
        "DATASETS.TEST", f"('{name}',)", "INPUT.MIN_SIZE_TRAIN", "(128,)",
        "INPUT.MAX_SIZE_TRAIN", "128", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "3",
        "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2", "TPU.EVAL_BATCH", "3",
        "TPU.NMS_GROUP_CANDIDATES", "32",
        "TPU.NMS_MAX_CANDIDATES", "128", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "200",
        "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100", "MODEL.DAFNE.NUM_CLASSES", "6",
        "DATALOADER.NUM_WORKERS", "1"]


def test_cli_trains_then_evaluates(tmp_path, records128):
    """3 train steps (checkpoints at 2 and 3, an evaluation at 2), then
    --eval-only restores the newest and writes results.txt, the Task1 files
    and test_results.csv; --resume with one more iteration trains step 4
    only."""
    name = "torch_cli_gen128"
    DatasetCatalog.register(name, lambda: records128[:4])
    MetadataCatalog[name] = {"evaluator_type": "synthetic", "thing_classes": GEN_CLASSES,
                             "is_test": False}
    args = _cli_args(tmp_path, name)
    trained = cli_main(args, device="cpu")
    ck = tmp_path / "checkpoints"
    assert sorted(os.listdir(ck)) == ["last_checkpoint", "model_0000002.pth", "model_0000003.pth"]
    assert (tmp_path / "metrics.json").exists() and (tmp_path / "config.yaml").exists()

    rows = (tmp_path / "test_results.csv").read_text().splitlines()
    assert {r.split(",")[0] for r in rows[1:]} == {"2", "0"}  # periodic eval, then the final one
    os.remove(tmp_path / "test_results.csv")
    stats = {}
    evaluated = cli_main(["--eval-only"] + args, device="cpu", stats=stats)
    assert evaluated == trained  # the restored weights are the trained ones
    assert stats[name]["images"] == len(stats[name]["preds"]) == 4
    out = tmp_path / "inference" / name
    assert (out / "results.txt").read_text().splitlines()[-1].startswith("mAP: ")
    assert sorted(os.listdir(out / "task1")) == sorted(f"Task1_{c}.txt" for c in GEN_CLASSES)
    assert (tmp_path / "test_results.csv").exists()
    # the config snapshot reads back through the port's own YAML reader
    snap = get_cfg()
    snap.merge_from_file(str(tmp_path / "config.yaml"))
    assert snap.OUTPUT_DIR == str(tmp_path) and snap.TPU.NMS_GROUP_CANDIDATES == 32

    cli_main(["--resume"] + args + ["SOLVER.MAX_ITER", "4", "TEST.EVAL_PERIOD", "0"], device="cpu")
    assert sorted(os.listdir(ck))[-1] == "model_0000004.pth"
    iters = [json.loads(line)["iteration"] for line in (tmp_path / "metrics.json").open()]
    assert iters[-1] == 4 and iters.count(4) == 1 and iters.count(1) == 1


def test_cli_failure_writes_error_txt(tmp_path):
    with pytest.raises(KeyError):
        cli_main(["--eval-only", "OUTPUT_DIR", str(tmp_path), "DATASETS.TEST", "('no_such_set',)"]
                 + [str(v) for v in NARROW], device="cpu")
    assert "no_such_set" in (tmp_path / "error.txt").read_text()
