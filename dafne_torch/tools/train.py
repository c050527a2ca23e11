"""Training and evaluation CLI of the port.

    python -m dafne_torch.tools.train --config-file configs/dota-1.0/1024.yaml \
        [--eval-only] [--resume] [KEY VALUE ...]

Counterpart of ``tools/train.py``: the config from the file (reading YAML
needs PyYAML; dotted overrides alone do not) and the dotted overrides,
``default_setup``, the model on the card, then either
``--eval-only`` (restore the newest checkpoint of OUTPUT_DIR, else
MODEL.WEIGHTS, run ``do_test`` and, with TEST.AUG.ENABLED,
``engine/tta.py::do_test_with_tta`` into results["tta"]) or ``do_train``
over DATASETS.TRAIN followed by ``do_test``.  A failure writes its
traceback to OUTPUT_DIR/error.txt.  One process on one device: no
distributed launch.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--debug", action="store_true", help="overfit-8 shortcut")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    return p.parse_args(argv)


def setup(args):
    from dafne_torch.config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.debug:
        cfg.DEBUG.OVERFIT_NUM_IMAGES = 8
        cfg.SOLVER.MAX_ITER = 20
        cfg.DATALOADER.NUM_WORKERS = 0
        cfg.MODEL.WEIGHTS = ""
        cfg.SOLVER.REFERENCE_WORLD_SIZE = 0
    return cfg


def main(argv=None, device: str = "cuda", stats=None, tta_stats=None, train_stats=None):
    """Run the CLI on `device` (the card unless a caller asks for "cpu").
    Returns do_test's results; `stats` is passed to the final do_test,
    `tta_stats` to do_test_with_tta and `train_stats` to do_train."""
    args = parse_args(argv)
    cfg = setup(args)

    from dafne_torch.data import get_dataset
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.engine.train_loop import default_setup, do_test, do_train
    from dafne_torch.engine.tta import do_test_with_tta
    from dafne_torch.models import build_model

    try:
        default_setup(cfg)
        model = build_model(cfg, device=device,
                            generator=torch.Generator().manual_seed(max(cfg.SEED, 0)))
        if args.eval_only:
            Checkpointer(cfg.OUTPUT_DIR).resume_or_load(model, cfg, resume=True)
            results = do_test(cfg, model, cfg.OUTPUT_DIR, stats=stats)
            if cfg.TEST.AUG.ENABLED:
                results["tta"] = do_test_with_tta(cfg, model, cfg.OUTPUT_DIR, stats=tta_stats)
            return results
        records = []
        for name in cfg.DATASETS.TRAIN:
            records += get_dataset(name, cfg)
        do_train(cfg, model, records, resume=args.resume, stats=train_stats)
        return do_test(cfg, model, cfg.OUTPUT_DIR, stats=stats)
    except Exception:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        with open(os.path.join(cfg.OUTPUT_DIR, "error.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    main(sys.argv[1:])
