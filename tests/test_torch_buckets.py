"""Bucketed multi-scale training (TPU.BUCKETED_TRAIN), port vs JAX.

``TrainScaleBuckets`` and ``train_canvas_buckets`` must give the JAX
package's ladder (canvases, each scale's canvas, the per-batch draw stream)
on HRSC2016-like record sizes and on the DOTA multi-scale tile sizes, and
take the same gating decisions (the JAX cases of ``tests/test_data.py``).
Then the batches ``do_train`` steps on, for the same records and seed, must
equal the JAX loader's with its buckets, batch by batch: the canvas, the
images bit for bit (or the device-aug base images and warp taps) and the
gts; and the port's loader with buckets gives every key of JAX's
(resized_hw, scale_xy included).  One scale is drawn per batch, from
``RandomState(seed * 7919 + 13)``; an image's own rng then draws no scale.
"""

import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.data.loader import DataLoader as JaxDataLoader
from dafne_tpu.data.mapper import pad_target_hw as jax_pad_target_hw
from dafne_tpu.data.mapper import train_canvas_buckets as jax_train_canvas_buckets

from dafne_torch.config import get_cfg
from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import TrainScaleBuckets, pad_target_hw, train_canvas_buckets
from dafne_torch.data.synthetic import load_synthetic_gen
from dafne_torch.engine import train_loop
from dafne_torch.models import build_model

from tests.test_torch_model import NARROW

torch.set_num_threads(1)

# configs/pre-trained/dota-1.0_r101_ms.yaml and hrsc_r50_ms.yaml: their
# scale ladders, largest sizes and rotation angles
DOTA_MS = ["INPUT.MIN_SIZE_TRAIN", "(450, 500, 600, 700, 800, 900, 1000, 1100, 1200)",
           "INPUT.MAX_SIZE_TRAIN", "1200",
           "INPUT.ROTATION_AUG_ANGLES", "(0.0, 90.0, 180.0, 270.0)"]
HRSC_MS = ["INPUT.MIN_SIZE_TRAIN",
           "(320, 400, 480, 560, 640, 720, 800, 880, 960, 1040, 1120, 1200, 1280, 1360, 1440, "
           "1520)", "INPUT.MAX_SIZE_TRAIN", "1520",
           "INPUT.ROTATION_AUG_ANGLES", "(0.0, 30.0, 60.0, 90.0, 120.0, 150.0)"]
# HRSC2016 image sizes (about 300 x 300 to 1500 x 900) and DOTA's square tiles
HRSC_WH = [(1166, 753), (1280, 800), (500, 333), (300, 300), (1500, 900), (933, 624),
           (1034, 632), (800, 600)]
DOTA_WH = [(s, s) for s in (600, 800, 1024, 1300, 1600)]


def cfgs(extra=()):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list([str(v) for v in extra])
    return jcfg, cfg


def sized(wh):
    return [{"width": w, "height": h} for w, h in wh]


@pytest.mark.parametrize("recipe,wh,max_buckets", [
    (HRSC_MS, HRSC_WH, None), (HRSC_MS, HRSC_WH[:3], 2), (HRSC_MS, HRSC_WH, 8),
    (DOTA_MS, DOTA_WH, None), (DOTA_MS, DOTA_WH[:2], 3),
    (DOTA_MS + ["INPUT.MIN_SIZE_TRAIN_SAMPLING", "range", "INPUT.MIN_SIZE_TRAIN", "(450, 1200)"],
     DOTA_WH, None),
    (HRSC_MS + ["TPU.IMAGE_SIZE_DIVISIBILITY", "32"], HRSC_WH, None),
])
def test_ladder_and_draws_equal_jax(recipe, wh, max_buckets):
    extra = [] if max_buckets is None else ["TPU.TRAIN_MAX_BUCKETS", str(max_buckets)]
    jcfg, cfg = cfgs(recipe + extra)
    ours, theirs = train_canvas_buckets(cfg, sized(wh)), jax_train_canvas_buckets(jcfg, sized(wh))
    assert ours is not None and theirs is not None
    assert ours.canvases == theirs.canvases
    assert 2 <= len(ours.canvases) <= (max_buckets or 4)
    assert ours.sizes == theirs.sizes and ours.sampling == theirs.sampling
    for s in range(300, 1700, 7):
        assert ours.canvas_for(s) == theirs.canvas_for(s), s
    seed = 3
    a, b = np.random.RandomState(seed * 7919 + 13), np.random.RandomState(seed * 7919 + 13)
    assert [ours.draw(a) for _ in range(64)] == [theirs.draw(b) for _ in range(64)]
    worst = pad_target_hw(cfg, train=True)
    assert all(h <= worst[0] and w <= worst[1] for h, w in ours.canvases)


@pytest.mark.parametrize("case,extra", [
    ("single scale", ["INPUT.MIN_SIZE_TRAIN", "(800,)"]),
    ("flag off", HRSC_MS + ["TPU.BUCKETED_TRAIN", "False"]),
    ("one canvas", ["INPUT.MIN_SIZE_TRAIN", "(224, 256)", "INPUT.MAX_SIZE_TRAIN", "256"]),
    ("both", HRSC_MS + ["INPUT.RESIZE_TYPE", "both"]),
    ("point range", ["INPUT.MIN_SIZE_TRAIN_SAMPLING", "range", "INPUT.MIN_SIZE_TRAIN",
                     "(800, 800)"]),
    ("reversed range", ["INPUT.MIN_SIZE_TRAIN_SAMPLING", "range", "INPUT.MIN_SIZE_TRAIN",
                        "(1200, 450)"]),
    ("range", DOTA_MS + ["INPUT.MIN_SIZE_TRAIN_SAMPLING", "range", "INPUT.MIN_SIZE_TRAIN",
                         "(450, 1200)"]),
    ("ladder", HRSC_MS),
])
def test_gating_equals_jax(case, extra):
    jcfg, cfg = cfgs(extra)
    for records in (sized(HRSC_WH), sized(HRSC_WH) + [{"width": 0, "height": 0}]):
        ours, theirs = train_canvas_buckets(cfg, records), jax_train_canvas_buckets(jcfg, records)
        assert (ours is None) == (theirs is None), case
        if ours is not None:
            assert ours.canvases == theirs.canvases
    assert (train_canvas_buckets(cfg, sized(HRSC_WH)) is None) == (case not in ("range", "ladder"))


def test_every_scale_fits_its_canvas():
    _, cfg = cfgs(HRSC_MS)
    b = TrainScaleBuckets(cfg, sized(HRSC_WH))
    from dafne_torch.data import transforms as T

    for s in b.sizes:
        ch, cw = b.canvas_for(s)
        for w, h in HRSC_WH:
            a = T.shortest_edge_resize(w, h, s, 1520)
            assert a.out_h <= ch and a.out_w <= cw


def _records(kind):
    """Small in-memory records: DOTA-like squares of two sizes, or
    HRSC-like non-square crops of synthetic scenes (annotations kept)."""
    base = load_synthetic_gen("train", 4, hw=160, max_boxes=10)
    if kind == "dota":
        sizes = [(160, 160), (128, 128), (160, 160), (128, 128)]
    else:
        sizes = [(150, 100), (120, 90), (160, 130), (96, 128)]
    out = []
    for r, (w, h) in zip(base, sizes):
        out.append(dict(r, image=np.ascontiguousarray(r["image"][:h, :w]), width=w, height=h))
    return out


SLICES = {
    "dota_ms-host": (DOTA_MS + ["TPU.TRAIN_DEVICE_AUG", "False"], "dota", 11),
    "dota_ms-device": (DOTA_MS + ["TPU.TRAIN_DEVICE_AUG", "True"], "dota", 11),
    "hrsc_ms-host": (HRSC_MS, "hrsc", 11),
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_do_train_batches_equal_jax_loader(tmp_path, name):
    """The fault test: the batches ``do_train`` runs its steps on (caught by
    a stand-in step) against the JAX loader's with its buckets."""
    extra, kind, seed = SLICES[name]
    records = _records(kind)
    run = NARROW + extra + ["SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "3", "SEED", str(seed),
                            "TPU.MAX_INSTANCES", "16", "DATALOADER.NUM_WORKERS", "2",
                            "OUTPUT_DIR", str(tmp_path)]
    jcfg, cfg = cfgs(run)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seen = []

    def stand_in(model, cfg, image_hw, optimizer, scheduler, device_aug=False):
        def step(batch):
            seen.append((tuple(image_hw), {k: v.numpy().copy() for k, v in batch.items()}))
            return {"loss/total": torch.tensor(0.0), "loss_is_finite": torch.tensor(True)}
        return step

    mp = pytest.MonkeyPatch()
    mp.setattr(train_loop, "make_train_step", stand_in)
    try:
        train_loop.do_train(cfg, model, records)
    finally:
        mp.undo()
    device_aug = name.endswith("device")
    buckets = jax_train_canvas_buckets(jcfg, records)
    theirs = iter(JaxDataLoader(jcfg, records, 2, train=True, seed=seed,
                                pad_hw=jax_pad_target_hw(jcfg, True), num_workers=2,
                                buckets=buckets, device_aug=device_aug))
    try:
        want = [next(theirs) for _ in range(3)]
    finally:
        theirs.close()
    assert len(seen) == 3
    canvases = set()
    for (hw, got), w in zip(seen, want):
        img_key = "image_base" if device_aug else "image"
        want_hw = (tuple(w["image"].shape[1:3]) if not device_aug
                   else (w["aug_idx0_h"].shape[1], w["aug_idx0_w"].shape[1]))
        assert hw == want_hw
        canvases.add(hw)
        keys = set(got) - {img_key}
        assert keys >= set(GT_KEYS)
        np.testing.assert_array_equal(got[img_key], w[img_key])
        for k in keys:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    assert len(canvases) >= 2, canvases  # the seed hits two bucket canvases


@pytest.mark.parametrize("name", ["dota_ms-host", "hrsc_ms-host"])
def test_bucketed_loader_equals_jax(name):
    extra, kind, seed = SLICES[name]
    records = _records(kind)
    jcfg, cfg = cfgs(extra + ["TPU.MAX_INSTANCES", "16", "DATALOADER.NUM_WORKERS", "2"])
    ours = iter(DataLoader(cfg, records, 2, seed=seed, buckets=train_canvas_buckets(cfg, records)))
    theirs = iter(JaxDataLoader(jcfg, records, 2, train=True, seed=seed,
                                buckets=jax_train_canvas_buckets(jcfg, records)))
    try:
        for _ in range(4):
            got, want = next(ours), next(theirs)
            assert set(got) == set(want)
            for k in want:
                g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
                np.testing.assert_array_equal(g, want[k], err_msg=k)
    finally:
        ours.close()
        theirs.close()
