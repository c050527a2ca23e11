"""TTA canary: the TTA merge path on trained weights, with real detections.

    python -m dafne_torch.tools.tta_canary [--out TTA_CANARY_TORCH.json] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/tta_canary.py``.  On random weights TTA merges
empty detection sets, so the synthetic canary recipe
(``configs/synthetic/base.yaml``, 32 overfit scenes, SOLVER.MAX_ITER from
CANARY_ITERS, default 800) is trained across the TTA ladder (shortest
edge 192-320, max 512: a fixed-scale model makes the off-scale copies
worse) and evaluated on its 32 train scenes: plainly (``do_test``), one
image through ``engine/tta.py::tta_inference_single`` (its detections
counted), and every image through ``do_test_with_tta`` (ladder 192, 256,
320, max 512, with flips; the copies per image from ``build_tta_augs``).
The gate is JAX's (:116-120, ``checks``): detections on image 0, the TTA
mAP at most 2.0 under the plain one, the plain one above 50.

Runs on the card unless ``--cpu`` is given, under the CLI's cuDNN
settings.  The run's files go to OUTPUT_DIR (default output/tta_canary).
Writes the record (JAX's fields, with "device" the card's name, and
"power_limit", "torch", "seed" and "checks") to ``--out``, prints it as
one JSON line and exits 1 when a check fails.  Trailing KEY VALUE pairs
override the config.  JAX's own record, TTA_CANARY.json, is never written.
"""

from __future__ import annotations

import os
import sys

from dafne_torch.tools import canary

ROOT = canary.ROOT
RECIPE = canary.RECIPE
OUT = os.path.join(ROOT, "TTA_CANARY_TORCH.json")
#: tools/tta_canary.py:54-70 (SOLVER.MAX_ITER from CANARY_ITERS in ``recipe``)
OVERRIDES = ["DEBUG.OVERFIT_NUM_IMAGES", "32",
             "INPUT.MIN_SIZE_TRAIN", "(192, 224, 256, 288, 320)", "INPUT.MAX_SIZE_TRAIN", "512",
             "SOLVER.CHECKPOINT_PERIOD", "10000000", "TEST.EVAL_PERIOD", "0",
             "DATASETS.TEST", "('synthetic_train',)", "TEST.AUG.ENABLED", "True",
             "TEST.AUG.MIN_SIZES", "(192, 256, 320)", "TEST.AUG.MAX_SIZE", "512",
             "OUTPUT_DIR", os.path.join(ROOT, "output", "tta_canary")]
MAX_DROP = 2.0  # the TTA mAP at most this far under the plain one (:118)


def checks(plain: float, tta: float, detections_img0: int) -> dict:
    """JAX's gate (tools/tta_canary.py:116-120), one verdict per line."""
    return {"tta_detections": detections_img0 > 0,
            "tta_within_2": tta >= plain - MAX_DROP,
            "plain_converged": plain > canary.MAP_GATE}


def recipe(opts=()):
    """The TTA canary's config: the recipe, JAX's overrides, then `opts`."""
    return canary.gate_recipe(OVERRIDES, opts)


def run(opts=(), device: str = "cuda", stats=None) -> dict:
    """Train on `device`, evaluate plainly and with TTA, and return the
    record, neither written nor printed.  A `stats` dict receives the train
    records' ids ("train_ids"), image 0's ``tta_inference_single`` stats
    ("img0": its copies among them) and its (height, width) ("img0_hw")."""
    from dafne_torch.data import get_dataset
    from dafne_torch.data.image_io import read_image
    from dafne_torch.engine.train_loop import do_test
    from dafne_torch.engine.tta import (
        BucketedEvalSteps,
        build_tta_augs,
        do_test_with_tta,
        tta_inference_single,
    )

    cfg = recipe(opts)
    (name,) = cfg.DATASETS.TEST
    with canary.cli_backend_flags():
        model, train_records, train_s = canary.train_recipe(cfg, device)
        plain = do_test(cfg, model, cfg.OUTPUT_DIR)[name]["mAP"]
        records = get_dataset(name, cfg)
        r0 = records[0]
        img = r0["image"] if "image" in r0 else read_image(r0["file_name"], cfg.INPUT.FORMAT)
        img0 = {}
        det0 = tta_inference_single(cfg, BucketedEvalSteps(cfg, model), img, img0)
        tta = do_test_with_tta(cfg, model, cfg.OUTPUT_DIR)[name]["mAP"]
    h0, w0 = img.shape[:2]
    if stats is not None:
        stats.update(train_ids=[r["image_id"] for r in train_records], img0=img0,
                     img0_hw=(h0, w0))
    verdicts = checks(plain, tta, len(det0["scores"]))
    return {"iters": cfg.SOLVER.MAX_ITER, "train_s": round(train_s, 1),
            "plain_mAP": round(plain, 2), "tta_mAP": round(tta, 2),
            "tta_detections_img0": int(len(det0["scores"])),
            "tta_augs": len(build_tta_augs(cfg, w0, h0)),
            "gt_img0": len(r0["annotations"]), **canary.card_fields(device),
            "seed": max(cfg.SEED, 0), "checks": verdicts, "ok": all(verdicts.values())}


def main(argv=None) -> int:
    return canary.gate_main(argv, __doc__, OUT, run)


if __name__ == "__main__":
    sys.exit(main())
