"""Held-out generalization gate: trained on one set of scenes, scored on another.

    python -m dafne_torch.tools.gen_canary [--scale 256|1024] [--resume-dir DIR]
        [--out GEN_CANARY_TORCH.json] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/gen_canary.py``.  The overfit canaries train and
score the same 32 scenes, which a sign error in an augmentation's inverse
would survive.  This trains the flagship R-50 from scratch on a
procedural 6-class set and scores it on disjoint held-out scenes (the
train and val seeds never overlap, ``data/synthetic.py::load_synthetic_gen``):

- ``--scale 256``: ``configs/synthetic/gen.yaml``, 2048 train scenes at
  256², multi-scale 224-320, 2500 steps, 64 val scenes;
- ``--scale 1024``: ``configs/synthetic/gen1024.yaml``, 512 dense scenes
  (up to 96 objects) at the 1024² deployment canvas, bucketed over 896 /
  1024 / 1152, NMS budget 4096, 3000 steps, 64 val scenes.

SOLVER.MAX_ITER comes from GEN_CANARY_ITERS (default ``_SCALES``'s iters)
and SOLVER.STEPS is [0.8 * MAX_ITER].  Five evaluations follow: the val
scenes plainly, a 64-scene slice of the train set, TTA on val (the
ladder inside the train scales, with flips), int8 dynamic on val, and
int8 static on val with scales calibrated on ``calib_batches`` eval
batches of *train* scenes, never val.  The checks are JAX's (:212-218,
``checks``): val at least 50, TTA at most 0.5 under val, each int8 mode at
most 1.0 under val, the train slice at most 5 under val.  ``--resume-dir``
is an OUTPUT_DIR with a checkpoint: training resumes (or is done) there and
the evaluations run, the salvage path of a run cut short.

Runs on the card unless ``--cpu`` is given, under the CLI's cuDNN
settings.  The run's files go to OUTPUT_DIR (default a fresh directory
under output/).  Writes the record (JAX's fields, with "device" the card's
name, and "power_limit", "torch", "seed", "calib_dataset" and
"calib_images") to ``--out`` (default ``_SCALES``'s file at the repo
root), prints it as one JSON line and exits 1 when a check fails.
Trailing KEY VALUE pairs override the config (SOLVER.STEPS follows the
final MAX_ITER).  JAX's records, GEN_CANARY.json and GEN_CANARY_1024.json,
are never written.
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile
import time

from dafne_torch.tools import canary

ROOT = canary.ROOT
#: tools/gen_canary.py:62-82, with the port's own records as "out"
_SCALES = {
    256: dict(
        cfg="gen.yaml", iters=2500, train_images=2048,
        train_name="synthetic_gen_train", tta_sizes=[192, 256, 320],
        tta_max=512, calib_batches=2, out="GEN_CANARY_TORCH.json",
    ),
    1024: dict(
        cfg="gen1024.yaml", iters=3000, train_images=512,
        train_name="synthetic_gen1024_train", tta_sizes=[896, 1024, 1152],
        tta_max=1280, calib_batches=8, out="GEN_CANARY_1024_TORCH.json",
    ),
}
TRAIN_SLICE = 64  # train scenes of the protocol check (:155-158)
CALIB_MIN_CHANNELS = 64  # the static auto width (:188)


def checks(val: float, train_slice: float, tta: float, dynamic: float, static: float) -> dict:
    """JAX's five checks (tools/gen_canary.py:212-218)."""
    return {"val_floor": val >= 50.0,
            "tta_holds_on_heldout": tta >= val - 0.5,
            "int8_dyn_within_1": dynamic >= val - 1.0,
            "int8_static_within_1": static >= val - 1.0,
            "train_slice_sane": train_slice >= val - 5.0}


def recipe(scale: int, opts=()):
    """The gate's config at `scale`: the recipe, SOLVER.MAX_ITER from
    GEN_CANARY_ITERS, a final checkpoint only, then `opts`; SOLVER.STEPS =
    [0.8 * MAX_ITER] last (:104-111)."""
    from dafne_torch.config import get_cfg

    p = _SCALES[scale]
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic", p["cfg"]))
    cfg.SOLVER.MAX_ITER = int(os.environ.get("GEN_CANARY_ITERS", p["iters"]))
    cfg.SOLVER.CHECKPOINT_PERIOD = 10_000_000
    cfg.merge_from_list(list(opts))
    cfg.SOLVER.STEPS = [int(0.8 * cfg.SOLVER.MAX_ITER)]
    return cfg


def _output_dir(scale: int) -> str:
    base = os.path.join(ROOT, "output")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"gen_canary_{scale}_", dir=base)


def run(scale: int = 256, opts=(), device: str = "cuda", resume_dir=None, stats=None) -> dict:
    """Train on `device` (or resume in `resume_dir`), run the five
    evaluations and return the record, neither written nor printed.  A
    `stats` dict receives the image ids of the train records ("train_ids"),
    of the val scenes ("val_ids"), of the train slice ("slice_ids") and of
    the images calibrated on ("calib_ids")."""
    from dafne_torch.data import get_dataset
    from dafne_torch.engine.train_loop import do_test
    from dafne_torch.engine.tta import do_test_with_tta
    from dafne_torch.layers.quant import save_act_scales
    from dafne_torch.tools.calibrate_int8 import calibrate

    p = _SCALES[scale]
    cfg = recipe(scale, opts)
    if resume_dir:
        cfg.OUTPUT_DIR = resume_dir
    elif not any(k == "OUTPUT_DIR" for k in list(opts)[0::2]):
        cfg.OUTPUT_DIR = _output_dir(scale)
    seen = {}

    def run_eval(what, *keys):
        """One evaluation of the trained model: `keys` (KEY VALUE pairs) over
        the config, its files under OUTPUT_DIR/<what>."""
        c = copy.deepcopy(cfg)
        c.merge_from_list(list(keys))
        (name,) = c.DATASETS.TEST
        if what in ("val", "train_slice"):
            seen[what] = [r["image_id"] for r in get_dataset(name, c)]
        test = do_test_with_tta if c.TEST.AUG.ENABLED else do_test
        t0 = time.perf_counter()
        res = test(c, model, os.path.join(cfg.OUTPUT_DIR, what))[name]
        return res["mAP"], time.perf_counter() - t0

    with canary.cli_backend_flags():
        model, train_records, train_s = canary.train_recipe(cfg, device, resume=bool(resume_dir))
        # 1. plainly on the held-out scenes
        val, val_s = run_eval("val")
        # 2. the protocol on train scenes (seen in training)
        n_slice = TRAIN_SLICE if cfg.DEBUG.OVERFIT_NUM_IMAGES <= 0 else min(
            TRAIN_SLICE, cfg.DEBUG.OVERFIT_NUM_IMAGES)
        train_slice, _ = run_eval("train_slice", "DATASETS.TEST", [p["train_name"]],
                                  "DEBUG.OVERFIT_NUM_IMAGES", n_slice)
        # 3. TTA on the held-out scenes
        tta, tta_s = run_eval("tta", "TEST.AUG.ENABLED", True, "TEST.AUG.MIN_SIZES",
                              p["tta_sizes"], "TEST.AUG.MAX_SIZE", p["tta_max"])
        # 4. int8 dynamic on the held-out scenes
        dynamic, dynamic_s = run_eval("int8_dynamic", "TPU.EVAL_INT8", True)
        # 5. int8 static: scales from train scenes only, scored on val
        calib_records = train_records[:p["calib_batches"] * int(cfg.TPU.EVAL_BATCH)]
        calib_ids = []
        scales = calibrate(cfg, model, calib_records, p["calib_batches"], CALIB_MIN_CHANNELS,
                           calib_ids)
        scales_path = os.path.join(cfg.OUTPUT_DIR, "int8_scales.json")
        save_act_scales(scales_path, scales)
        static, _ = run_eval("int8_static", "TPU.EVAL_INT8", True,
                             "TPU.EVAL_INT8_SCALES", scales_path)
    if stats is not None:
        stats.update(train_ids=[r["image_id"] for r in train_records], val_ids=seen["val"],
                     slice_ids=seen["train_slice"], calib_ids=calib_ids)
    verdicts = checks(val, train_slice, tta, dynamic, static)
    return {"scale": scale, "iters": cfg.SOLVER.MAX_ITER, "train_images": len(train_records),
            "val_images": len(seen["val"]), "train_s": round(train_s, 1),
            "train_mAP": round(train_slice, 2), "val_mAP": round(val, 2),
            "val_tta_mAP": round(tta, 2), "val_int8_mAP": round(dynamic, 2),
            "val_int8_static_mAP": round(static, 2), "calibrated_sites": len(scales),
            "val_eval_s": round(val_s, 1), "tta_eval_s": round(tta_s, 1),
            "int8_eval_s": round(dynamic_s, 1), **canary.card_fields(device),
            "seed": max(cfg.SEED, 0), "calib_dataset": p["train_name"],
            "calib_images": len(calib_ids), "checks": verdicts, "ok": all(verdicts.values())}


def main(argv=None) -> int:
    p = canary.gate_parser(__doc__, None)
    p.add_argument("--scale", type=int, choices=sorted(_SCALES), default=256)
    p.add_argument("--resume-dir", help="an OUTPUT_DIR with a checkpoint: resume (or skip) "
                   "training there and run the evaluations")
    a = p.parse_args(argv)
    record = run(a.scale, a.opts, "cpu" if a.cpu else "cuda", a.resume_dir)
    return canary.report(record, a.out or os.path.join(ROOT, _SCALES[a.scale]["out"]))


if __name__ == "__main__":
    sys.exit(main())
