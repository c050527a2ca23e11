"""Train-time device augmentation (TPU.TRAIN_DEVICE_AUG), port vs JAX.

The DOTA recipe's draws (hflip, vflip, rotations by 0/90/180/270) on
seeded 128^2 synthetic records, at unit scale and with a multi-scale
shortest-edge resize, through the port's and the JAX package's device-aug
mappers and loaders with the same seeds: the examples' base images, warp
and color vectors and corners equal; the rendered canvases within 1e-3 of
JAX's (0-255 scale); at unit scale the canvas equals the host path's bit
for bit.  ``resolve_train_device_aug`` follows the JAX rules, and a
3-step narrow ``do_train`` with device aug runs with finite losses.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dafne_tpu.engine.trainer as jax_trainer
from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data.loader import DataLoader as JaxDataLoader
from dafne_tpu.data.mapper import DatasetMapper as JaxMapper
from dafne_tpu.data.mapper import device_aug_base_hw as jax_device_aug_base_hw

from dafne_torch.config import get_cfg
from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import DatasetMapper, device_aug_base_hw
from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine import trainer
from dafne_torch.engine.train_loop import DEVICE_AUG_KEYS, do_train, to_device
from dafne_torch.models import build_model

from test_torch_model import NARROW

torch.set_num_threads(1)

WARP_TOL = 1e-3  # 0-255 scale
RECIPE = ["INPUT.MAX_SIZE_TRAIN", "128", "TPU.MAX_INSTANCES", "16",
          "INPUT.ROTATION_AUG_ANGLES", "[0.0, 90.0, 180.0, 270.0]"]
SCALES = {"unit": ["INPUT.MIN_SIZE_TRAIN", "(128,)"],
          "multi-scale": ["INPUT.MIN_SIZE_TRAIN", "(80, 104, 128)"]}


def cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(RECIPE + list(extra))
    return jcfg, cfg


@pytest.fixture(scope="module")
def records():
    return load_synthetic_gen("train", 6, hw=128, max_boxes=12)


def _jax_aug_image(batch, color):
    """JAX's device_aug_image on a numpy batch."""
    keys = ["image_base", "aug_out_hw", *jax_trainer._AUG_KEYS]
    if color:
        keys += ["color_light", "color_w"]
    return np.asarray(jax_trainer.device_aug_image({k: jnp.asarray(batch[k]) for k in keys}, color))


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("color", [False, True])
def test_device_aug_mapper_and_image_match_jax(records, scale, color):
    jcfg, cfg = cfgs(SCALES[scale] + ["INPUT.USE_COLOR_AUGMENTATIONS", str(color)])
    ours = DatasetMapper(cfg, (128, 128), device_aug=True)
    theirs = JaxMapper(jcfg, True, (128, 128), device_aug=True)
    host = DatasetMapper(cfg, (128, 128))
    got_all, want_all, transposed = [], [], set()
    for seed in range(8):
        rec = records[seed % len(records)]
        got = ours(rec, np.random.RandomState(seed))
        want = theirs(rec, np.random.RandomState(seed))
        assert set(got) == set(want)
        for key in want:
            if key != "image_id":
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
                assert got[key].dtype == np.asarray(want[key]).dtype, key
        transposed.add(not np.array_equal(got["image_base"], rec["image"]))
        got_all.append(got)
        want_all.append(want)
        if scale == "unit" and not color:  # the host path's canvas, bit for bit
            one = {k: torch.from_numpy(np.asarray(got[k])[None]) for k in DEVICE_AUG_KEYS
                   if k in got}
            rendered = trainer.device_aug_image(one, False)[0].numpy()
            canvas = host(rec, np.random.RandomState(seed))["image"]
            np.testing.assert_array_equal(rendered, canvas.astype(np.float32))
    assert transposed == {False, True}  # anti-diagonal draws ship a transposed base
    batch = {k: np.stack([g[k] for g in got_all]) for k in got_all[0] if k != "image_id"}
    rendered = trainer.device_aug_image({k: torch.from_numpy(v) for k, v in batch.items()},
                                        color).numpy()
    want = _jax_aug_image({k: np.stack([w[k] for w in want_all]) for k in batch}, color)
    assert rendered.shape == want.shape == (8, 128, 128, 3)
    diff = np.abs(rendered - want)
    if not color:
        assert diff.max() <= WARP_TOL, diff.max()
    else:
        # the jitter rounds the warp to uint8 first: an ulp of the resampled
        # value can flip that rounding, a level the brightness, contrast and
        # saturation weights (each at most 1.5) can grow to 3 by truncation;
        # at unit scale the warp is exact and the jitter stays within a level
        assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
        assert diff.max() <= (1.0 if scale == "unit" else 4.0), diff.max()


def test_device_aug_color_is_within_one_level_of_the_host(records):
    """float32 stages against the host's float64 ones: truncation may
    differ by a level (the JAX package's device jitter does the same)."""
    jcfg, cfg = cfgs(SCALES["unit"] + ["INPUT.USE_COLOR_AUGMENTATIONS", "True"])
    ours = DatasetMapper(cfg, (128, 128), device_aug=True)
    host = DatasetMapper(cfg, (128, 128))
    for seed in range(4):
        rec = records[seed]
        ex = ours(rec, np.random.RandomState(seed))
        one = {k: torch.from_numpy(np.asarray(ex[k])[None]) for k in DEVICE_AUG_KEYS}
        rendered = trainer.device_aug_image(one, True)[0].numpy()
        canvas = host(rec, np.random.RandomState(seed))["image"].astype(np.float32)
        assert np.abs(rendered - canvas).max() <= 1.0


def test_device_aug_base_hw_matches_jax():
    cases = [[{"width": 300, "height": 200}, {"width": 150, "height": 400}],
             [{"image": np.zeros((90, 120, 3), np.uint8)}],
             [{"width": 64, "height": 64}, {}]]
    for recs in cases:
        assert device_aug_base_hw(recs) == jax_device_aug_base_hw(recs)
    assert device_aug_base_hw(cases[0]) == (400, 400) and device_aug_base_hw(cases[2]) is None


def test_device_aug_loader_matches_jax(records):
    jcfg, cfg = cfgs(SCALES["multi-scale"] + ["DATALOADER.NUM_WORKERS", "2",
                                              "INPUT.USE_COLOR_AUGMENTATIONS", "True"])
    ours = DataLoader(cfg, records, 3, seed=2, pad_hw=(128, 128), device_aug=True)
    theirs = JaxDataLoader(jcfg, records, 3, train=True, seed=2, pad_hw=(128, 128),
                           device_aug=True)
    assert ours.device_aug and theirs.device_aug and ours.base_hw == theirs.base_hw == (128, 128)
    ours_it, theirs_it = iter(ours), iter(theirs)
    try:
        for _ in range(2):
            got, want = next(ours_it), next(theirs_it)
            assert "image" not in got and got["image_base"].dtype == torch.uint8
            for key in DEVICE_AUG_KEYS + GT_KEYS:
                np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
            moved = to_device(got, "cpu")
            assert set(moved) == set(DEVICE_AUG_KEYS + GT_KEYS)
    finally:
        ours_it.close()
        theirs_it.close()
    # records without a size fall back to the host path
    sizeless = [{k: v for k, v in r.items() if k not in ("image", "width", "height")}
                for r in records]
    assert not DataLoader(cfg, sizeless, 3, pad_hw=(128, 128), device_aug=True).device_aug


@pytest.mark.parametrize("cores", [1, 2, 8])
def test_resolve_train_device_aug_follows_jax(monkeypatch, cores):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)), raising=False)
    separable = ["INPUT.ROTATION_AUG_ANGLES", "[0.0, 90.0, 180.0, 270.0]"]
    ranged = ["INPUT.ROTATION_AUG_ANGLES", "[-30.0, 30.0]", "INPUT.ROTATION_AUG_SAMPLE_STYLE",
              "range"]
    general = ["INPUT.ROTATION_AUG_ANGLES", "[0.0, 30.0]"]
    seen = set()
    for angles in (separable, ranged, general, ["INPUT.ROTATION_AUG_ANGLES", "[]"]):
        for value in (False, "False", True, "True", "auto", "AUTO", "maybe"):
            jcfg, cfg = cfgs(angles)
            jcfg.TPU.TRAIN_DEVICE_AUG = cfg.TPU.TRAIN_DEVICE_AUG = value
            try:
                want = jax_trainer.resolve_train_device_aug(jcfg)
            except ValueError:
                with pytest.raises(ValueError):
                    trainer.resolve_train_device_aug(cfg)
                seen.add("error")
                continue
            assert trainer.resolve_train_device_aug(cfg) == want, (angles, value)
            seen.add(want)
    assert seen == {True, False, "error"}


@pytest.mark.parametrize("color", [False, True])
def test_narrow_do_train_with_device_aug(tmp_path, records, color):
    _, cfg = cfgs(SCALES["multi-scale"] + [str(v) for v in NARROW] + [
        "TPU.TRAIN_DEVICE_AUG", "True", "INPUT.USE_COLOR_AUGMENTATIONS", str(color),
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "3", "SOLVER.WARMUP_ITERS", "0",
        "SOLVER.BASE_LR", "0.01", "DATALOADER.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp_path)])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    made = []
    build_step = trainer.make_train_step

    def keep(*args, **kwargs):
        made.append(kwargs.get("device_aug"))
        return build_step(*args, **kwargs)

    import dafne_torch.engine.train_loop as train_loop

    mp = pytest.MonkeyPatch()
    mp.setattr(train_loop, "make_train_step", keep)
    try:
        last = do_train(cfg, model, records)
    finally:
        mp.undo()
    assert made == [True]
    losses = [v for k, v in last.items() if k.startswith("loss/")]
    assert len(losses) >= 4 and all(np.isfinite(losses)) and last["loss_is_finite"]
    assert (tmp_path / "checkpoints" / "model_0000003.pth").exists()
