"""The HRSC2016 multi-scale slice as a whole, port vs JAX, on a tiny BMP tree.

An HRSC2016 tree of non-square 24-bit BMPs (``chip_smoke.write_hrsc_tree``:
4 trainval and 4 test images of four sizes, ships drawn as filled rotated
rectangles, a planted point and axis-aligned segment on every fourth
image) under DAFNE_DATA_DIR.  Then:

- the eval examples of ``hrsc_test`` at the recipe's 800/1333
  (``configs/pre-trained/hrsc_r50_ms.yaml``) equal the JAX mapper's bit for
  bit, on the same tight canvas, with the planted objects dropped;
- ``Predictor``'s canvas and scale of a request equal the eval mapper's
  and the JAX server's ``DetectorService.preprocess``;
- a 3-step bucketed ``do_train`` with the recipe's angles over two
  canvases builds each canvas's step once, and its losses match the JAX
  step's on the same batches and targets (rtol 1e-4, as
  ``tests/test_torch_train_step.py``);
- the CLI with ``--config-file configs/pre-trained/hrsc_r50_ms.yaml`` at a
  narrow width and a cut ladder trains, evaluates and runs TTA on the tree.

TTA's host path against JAX's is ``tests/test_torch_tta_host.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data import get_dataset as jax_get_dataset
from dafne_tpu.data.mapper import DatasetMapper as JaxDatasetMapper
from dafne_tpu.data.mapper import eval_pad_hw as jax_eval_pad_hw
from dafne_tpu.data.mapper import eval_preprocess_meta
from dafne_tpu.data.registry import register_all_datasets as jax_register_all
from dafne_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from dafne_tpu.engine.trainer import TrainState
from dafne_tpu.engine.trainer import make_train_step as jax_make_train_step
from dafne_tpu.models import build_model as jax_build_model

import dafne_torch.engine.train_loop as train_loop
from dafne_torch.config import get_cfg
from dafne_torch.data import get_dataset, register_all_datasets
from dafne_torch.data import image_warp as IW
from dafne_torch.data.image_io import read_image
from dafne_torch.data.mapper import DatasetMapper, eval_pad_hw, pad_target_hw
from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine.predictor import Predictor
from dafne_torch.engine.trainer import batch_targets, make_location_tables
from dafne_torch.models import build_model
from dafne_torch.ops.targets import AssignmentSpec
from dafne_torch.tools.train import main as cli_main

from chip_smoke import write_hrsc_tree
from test_torch_model import NARROW, narrow_cfgs, port_model_from, random_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from serve import DetectorService  # noqa: E402

torch.set_num_threads(2)

RECIPE = os.path.join(ROOT, "configs", "pre-trained", "hrsc_r50_ms.yaml")
SIZES = ((150, 100), (120, 90), (97, 131), (160, 130))  # (width, height)
HRSC_ANGLES = ["INPUT.ROTATION_AUG_ANGLES", "(0.0, 30.0, 60.0, 90.0, 120.0, 150.0)"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hrsc_slice")
    data = str(root / "data")
    made = write_hrsc_tree(os.path.join(data, "hrsc"), {"trainval": 4, "test": 4},
                           np.random.RandomState(0), sizes=SIZES)
    return root, data, made


@pytest.fixture
def data_root(tree, monkeypatch):
    root, data, made = tree
    monkeypatch.setenv("DAFNE_DATA_DIR", data)
    return root, made


def _recipe_cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_file(RECIPE)
        c.merge_from_list([str(v) for v in list(NARROW) + list(extra)])
    return jcfg, cfg


def test_eval_examples_equal_jax_mapper(data_root):
    _, made = data_root
    jcfg, cfg = _recipe_cfgs(["TPU.MAX_INSTANCES", "16"])
    assert (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST) == (800, 1333)
    register_all_datasets(cfg)
    jax_register_all(jcfg)
    records, jrecords = get_dataset("hrsc_test", cfg), jax_get_dataset("hrsc_test", jcfg)
    assert len(records) == 4 and "image" not in records[0]
    pad = eval_pad_hw(cfg, records)
    assert pad == jax_eval_pad_hw(jcfg, jrecords) == (1152, 1280)  # a non-square canvas
    ours, theirs = DatasetMapper(cfg, pad, train=False), JaxDatasetMapper(jcfg, False, pad)
    IW.reset_launch_counts()
    sizes = set()
    for rec, jrec in zip(records, jrecords):
        got, want = ours(rec), theirs(jrec)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert int(got["gt_valid"].sum()) == len(rec["annotations"]) - made["planted"].get(
            rec["image_id"], 0)
        sizes.add(tuple(got["resized_hw"]))
        assert min(got["resized_hw"]) == 800
    assert len(sizes) == 4 and IW.resize_linear.launches == 4


def test_predictor_canvas_equals_eval_mapper_and_jax_server(data_root):
    _, made = data_root
    jcfg, cfg = _recipe_cfgs()
    model = build_model(cfg, device="cpu")
    predictor = Predictor(model, cfg, batch=1)
    pad = pad_target_hw(cfg, train=False)
    assert predictor.canvas_hw == pad == (1408, 1408)
    mapper = DatasetMapper(cfg, pad, train=False)
    service = DetectorService(None, 1, pad, eval_preprocess_meta(jcfg))
    paths = sorted(made["expected"])[:2]
    images = [read_image(p) for p in paths]
    rng = np.random.RandomState(4)
    images.append(rng.uniform(-30, 290, (70, 110, 3)).astype(np.float32))  # float pixels
    for img in images:
        canvas, scale = predictor.canvas([img])
        want = mapper({"image": np.clip(img, 0, 255).astype(np.uint8)})
        np.testing.assert_array_equal(canvas[0].numpy(), want["image"])
        np.testing.assert_array_equal(scale[0].numpy(), want["scale_xy"])
        jimages, jscale = service.preprocess(img)
        np.testing.assert_array_equal(canvas.numpy().astype(np.float32), jimages)
        np.testing.assert_array_equal(scale.numpy(), jscale)


def _hrsc_like_records():
    """Non-square crops of synthetic scenes, with their annotations."""
    base = load_synthetic_gen("train", 4, hw=128, max_boxes=10)
    out = []
    for r, (w, h) in zip(base, ((120, 90), (100, 80), (128, 96), (90, 120))):
        out.append(dict(r, image=np.ascontiguousarray(r["image"][:h, :w]), width=w, height=h))
    return out


def test_bucketed_do_train_matches_jax_losses(tmp_path):
    train = HRSC_ANGLES + [
        "INPUT.MIN_SIZE_TRAIN", "(64, 160)", "INPUT.MAX_SIZE_TRAIN", "256",
        "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0", "SOLVER.IMS_PER_BATCH", "2",
        "SOLVER.MAX_ITER", "3", "SEED", "4", "TPU.MAX_INSTANCES", "16",
        "MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0", "DATALOADER.NUM_WORKERS", "2",
        "OUTPUT_DIR", str(tmp_path)]
    jcfg, tcfg = narrow_cfgs(train)
    jmodel = jax_build_model(jcfg)
    params = random_flax_params(jmodel, seed=11)
    model = port_model_from(params, tcfg)
    built, seen = [], []
    real = train_loop.make_train_step

    def recording(model, cfg, image_hw, optimizer, scheduler, device_aug=False):
        built.append(tuple(image_hw))
        step = real(model, cfg, image_hw, optimizer, scheduler, device_aug=device_aug)

        def run(batch):
            b = {k: v.clone() for k, v in batch.items()}
            metrics = step(batch)
            seen.append((tuple(image_hw), b, {k: float(v) for k, v in metrics.items()}))
            return metrics
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(train_loop, "make_train_step", recording)
    stats = {}
    IW.reset_launch_counts()
    try:
        train_loop.do_train(tcfg, model, _hrsc_like_records(), stats=stats)
    finally:
        mp.undo()
    canvases = [hw for hw, _, _ in seen]
    assert len(seen) == 3 and len(set(canvases)) == 2, canvases
    assert sorted(built) == sorted(set(canvases))  # each canvas's step built once
    assert stats["canvases"] == [(128, 128), (256, 256)]
    assert {hw: v["builds"] for hw, v in stats["steps"].items()} == {hw: 1 for hw in built}
    assert sum(len(v["ms"]) for v in stats["steps"].values()) == 3
    assert IW.warp_affine_linear.launches > 0  # 30-degree draws went through the warp

    tx, sched = jax_build_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams, opt_state=tx.init(jparams),
                       tx=tx)
    spec = AssignmentSpec.from_config(tcfg)
    jsteps = {}
    for it, (hw, batch, got) in enumerate(seen):
        if hw not in jsteps:
            jsteps[hw] = jax.jit(jax_make_train_step(jmodel, jcfg, hw, tx, sched))
        targets = batch_targets(batch, spec, make_location_tables(hw, spec))
        jbatch = {k: jnp.asarray(v.numpy().astype(np.float32) if k == "image" else v.numpy())
                  for k, v in batch.items()}
        jbatch.update({f"tgt_{k}": jnp.asarray(targets[k].numpy())
                       for k in ("labels", "reg_corners", "reg_abcd")})
        state, want = jsteps[hw](state, jbatch)
        assert float(want["num_pos"]) > 0
        for key in want:
            np.testing.assert_allclose(got[key], float(want[key]), rtol=1e-4,
                                       err_msg=f"step {it} {key}")


def test_cli_hrsc_recipe_on_the_tree(data_root):
    """The recipe file at a narrow width, its ladder and TTA cut for the
    CPU: train 2 steps on hrsc_trainval, evaluate hrsc_test, then
    --eval-only with TTA (flips of two scales)."""
    root, _ = data_root
    out = root / "cli"
    args = ["--config-file", RECIPE] + [str(v) for v in NARROW] + [
        "SOLVER.REFERENCE_WORLD_SIZE", "0", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
        "INPUT.MIN_SIZE_TRAIN", "(96, 192)", "INPUT.MAX_SIZE_TRAIN", "256",
        "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "192", "TPU.EVAL_BATCH", "2",
        "TEST.AUG.MIN_SIZES", "(96, 128)", "TEST.AUG.MAX_SIZE", "192",
        "TPU.NMS_MAX_CANDIDATES", "256", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100",
        "MODEL.WEIGHTS", "", "DATALOADER.NUM_WORKERS", "2", "OUTPUT_DIR", str(out)]
    results = cli_main(args, device="cpu")
    assert set(results) == {"hrsc_test"} and np.isfinite(results["hrsc_test"]["mAP"])
    assert (out / "checkpoints" / "model_0000002.pth").exists()
    tta_stats = {}
    results = cli_main(["--eval-only"] + args, device="cpu", tta_stats=tta_stats)
    assert set(results) == {"hrsc_test", "tta"} and "mAP" in results["tta"]["hrsc_test"]
    assert tta_stats["hrsc_test"]["images"] == 4
