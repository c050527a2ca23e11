"""int8 canary: the int8 eval's accuracy gate on trained weights.

    python -m dafne_torch.tools.int8_canary [--out INT8_CANARY_TORCH.json] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/int8_canary.py``.  Random weights say nothing of
detection quality, so the synthetic canary recipe
(``configs/synthetic/base.yaml`` with 32 overfit scenes, SOLVER.MAX_ITER
from CANARY_ITERS, default 800, its test set the 32 train scenes) is
trained, and one set of weights is evaluated three times: in bf16, in int8
with dynamic scales (``TPU.EVAL_INT8``), and in int8 with static scales
calibrated (``tools/calibrate_int8.py::calibrate``, every conv of 64
channels or more) on 2 eval batches of the train scenes, written to
OUTPUT_DIR/int8_scales.json and read through ``TPU.EVAL_INT8_SCALES``.  The
gate is JAX's (:128-133, ``checks``): each int8 mAP at most 1.0 under bf16,
bf16 above 50 (the canary converged) and at least one calibrated site.

Runs on the card unless ``--cpu`` is given, under the CLI's cuDNN settings
(``canary.cli_backend_flags``).  The run's files go to OUTPUT_DIR (default
output/int8_canary).  Writes the record (JAX's fields, with "device" the
card's name, and "power_limit", "torch", "seed" and "checks") to ``--out``,
prints it as one JSON line and exits 1 when a check fails.  Trailing KEY
VALUE pairs override the config (a short run on the CPU: ``--cpu
SOLVER.MAX_ITER 2 ...``).  JAX's own record, INT8_CANARY.json, is never
written.
"""

from __future__ import annotations

import copy
import os
import sys
import time

from dafne_torch.tools import canary

ROOT = canary.ROOT
RECIPE = canary.RECIPE
OUT = os.path.join(ROOT, "INT8_CANARY_TORCH.json")
#: tools/int8_canary.py:47-63 (SOLVER.MAX_ITER from CANARY_ITERS in ``recipe``)
OVERRIDES = ["DEBUG.OVERFIT_NUM_IMAGES", "32", "SOLVER.CHECKPOINT_PERIOD", "10000000",
             "TEST.EVAL_PERIOD", "0", "DATASETS.TEST", "('synthetic_train',)",
             "OUTPUT_DIR", os.path.join(ROOT, "output", "int8_canary")]
CALIB_BATCHES = 2  # eval batches of the train scenes (:100-104)
CALIB_MIN_CHANNELS = 64  # the static auto width (:98)
MAX_DROP = 1.0  # int8 mAP at most this far under bf16 (:129-130)


def checks(bf16: float, dynamic: float, static: float, sites: int) -> dict:
    """JAX's gate (tools/int8_canary.py:128-133), one verdict per line."""
    return {"int8_dyn_within_1": dynamic >= bf16 - MAX_DROP,
            "int8_static_within_1": static >= bf16 - MAX_DROP,
            "bf16_converged": bf16 > canary.MAP_GATE,
            "calibrated_sites": sites > 0}


def recipe(opts=()):
    """The canary's config: the recipe, JAX's overrides, then `opts`."""
    return canary.gate_recipe(OVERRIDES, opts)


def evaluate(cfg, model, out_dir: str, stats=None) -> dict:
    """bf16, int8 dynamic and int8 static mAPs of `model` (on its device,
    trained) on DATASETS.TEST[0], the static scales calibrated on
    CALIB_BATCHES eval batches of DATASETS.TRAIN[0]: the record's mAP,
    site and eval-seconds fields, unrounded.  Each evaluation writes its
    files under `out_dir`/<mode>; the scales go to `out_dir`/int8_scales.json.
    A `stats` dict receives the ids of the images calibrated on
    ("calib_ids")."""
    from dafne_torch.data import get_dataset
    from dafne_torch.engine.train_loop import do_test
    from dafne_torch.layers.quant import save_act_scales
    from dafne_torch.tools.calibrate_int8 import calibrate

    (name,) = cfg.DATASETS.TEST

    def timed_test(mode, **keys):
        c = copy.deepcopy(cfg)
        for k, v in keys.items():
            c.TPU[k] = v
        t0 = time.perf_counter()
        res = do_test(c, model, os.path.join(out_dir, mode))[name]
        return res["mAP"], time.perf_counter() - t0

    bf16, bf16_s = timed_test("bf16")
    dynamic, dynamic_s = timed_test("int8_dynamic", EVAL_INT8=True)
    ids = []
    scales = calibrate(cfg, model, get_dataset(cfg.DATASETS.TRAIN[0], cfg), CALIB_BATCHES,
                       CALIB_MIN_CHANNELS, ids)
    os.makedirs(out_dir, exist_ok=True)
    scales_path = os.path.join(out_dir, "int8_scales.json")
    save_act_scales(scales_path, scales)
    static, static_s = timed_test("int8_static", EVAL_INT8=True, EVAL_INT8_SCALES=scales_path)
    if stats is not None:
        stats["calib_ids"] = ids
    return {"bf16_mAP": bf16, "int8_mAP": dynamic, "int8_static_mAP": static,
            "calibrated_sites": len(scales), "bf16_eval_s": bf16_s, "int8_eval_s": dynamic_s,
            "int8_static_eval_s": static_s}


def run(opts=(), device: str = "cuda", stats=None) -> dict:
    """Train the canary on `device`, evaluate it (``evaluate``) and return
    the record, neither written nor printed.  A `stats` dict receives
    ``evaluate``'s and the train records' ids ("train_ids")."""
    cfg = recipe(opts)
    with canary.cli_backend_flags():
        model, records, train_s = canary.train_recipe(cfg, device)
        ev = evaluate(cfg, model, cfg.OUTPUT_DIR, stats)
    if stats is not None:
        stats["train_ids"] = [r["image_id"] for r in records]
    verdicts = checks(ev["bf16_mAP"], ev["int8_mAP"], ev["int8_static_mAP"],
                      ev["calibrated_sites"])
    record = {"iters": cfg.SOLVER.MAX_ITER, "train_s": round(train_s, 1),
              **{k: round(v, 2) if k.endswith("mAP") else v for k, v in ev.items()
                 if not k.endswith("_s")},
              **{k: round(v, 1) for k, v in ev.items() if k.endswith("_s")},
              **canary.card_fields(device), "seed": max(cfg.SEED, 0),
              "checks": verdicts, "ok": all(verdicts.values())}
    return record


def main(argv=None) -> int:
    return canary.gate_main(argv, __doc__, OUT, run)


if __name__ == "__main__":
    sys.exit(main())
