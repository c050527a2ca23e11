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
traceback to OUTPUT_DIR/error.txt (error_rank<r>.txt for each process of
a process group).  The last log line of a run is its summary, one JSON
object: the process's rank, its kernels' launches, its peak device memory
and, after training, each step's ms and total loss.

Several processes, one per card (``parallel/distributed.py``): the
environment forms the process group before anything else, each process
builds the model on its own card (``local_device``), and the group is left
on the way out, on an error too.  Two processes on the CPU:

    for r in 0 1; do DAFNE_COORDINATOR=localhost:29500 DAFNE_NUM_PROCESSES=2 \
        DAFNE_PROCESS_ID=$r python -m dafne_torch.tools.train --cpu ... & done

or ``DAFNE_DISTRIBUTED=auto torchrun --nproc-per-node N -m
dafne_torch.tools.train ...`` on N cards.
"""

from __future__ import annotations

import argparse
import json
import logging
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
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
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
    """Run the CLI on `device` (the card unless a caller, or --cpu, asks for
    the CPU).  Returns do_test's results; `stats` is passed to the final
    do_test, `tta_stats` to do_test_with_tta and `train_stats` to do_train."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else device
    from dafne_torch.parallel import distributed as dist

    grouped = dist.maybe_initialize_distributed(device=device)
    try:
        return _run(args, device, grouped, stats, tta_stats, train_stats)
    finally:
        if grouped:
            dist.destroy()


def _run(args, device, grouped, stats, tta_stats, train_stats):
    from dafne_torch.parallel import distributed as dist

    cfg = setup(args)
    train_stats = {} if train_stats is None else train_stats
    try:
        from dafne_torch.data import get_dataset
        from dafne_torch.engine.checkpoint import Checkpointer
        from dafne_torch.engine.train_loop import default_setup, do_test, do_train
        from dafne_torch.engine.tta import do_test_with_tta
        from dafne_torch.models import build_model

        default_setup(cfg)
        dev = dist.local_device(device)
        model = build_model(cfg, device=dev,
                            generator=torch.Generator().manual_seed(max(cfg.SEED, 0)))
        if args.eval_only:
            Checkpointer(cfg.OUTPUT_DIR).resume_or_load(model, cfg, resume=True)
            results = do_test(cfg, model, cfg.OUTPUT_DIR, stats=stats)
            if cfg.TEST.AUG.ENABLED:
                results["tta"] = do_test_with_tta(cfg, model, cfg.OUTPUT_DIR, stats=tta_stats)
        else:
            records = []
            for name in cfg.DATASETS.TRAIN:
                records += get_dataset(name, cfg)
            do_train(cfg, model, records, resume=args.resume, stats=train_stats)
            results = do_test(cfg, model, cfg.OUTPUT_DIR, stats=stats)
        logging.getLogger("dafne_torch").info("run summary " + json.dumps(run_summary(dev, train_stats)))
        return results
    except Exception:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        name = f"error_rank{dist.process_index()}.txt" if grouped else "error.txt"
        with open(os.path.join(cfg.OUTPUT_DIR, name), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_summary(device, train_stats) -> dict:
    """This process's rank, world size, collectives backend (None without a
    process group), kernel launches, peak device memory
    (GiB, None off the card) and, after training, each step's ms and total
    loss in step order (from ``do_train``'s stats)."""
    from dafne_torch.ops.kernels import assign, quad_nms
    from dafne_torch.parallel import distributed as dist

    out = {"rank": dist.process_index(), "world": dist.process_count(),
           "backend": dist.backend(),
           "launches": {"suppression_matrix": quad_nms.suppression_bits_cuda.launches,
                        "greedy_keep": quad_nms.greedy_keep_bits_cuda.launches,
                        "assign_argmin": assign.assign_argmin_cuda.launches},
           "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                               if device.type == "cuda" else None)}
    steps = train_stats.get("steps") or {}
    if len(steps) == 1:  # one canvas: the steps in order
        (v,) = steps.values()
        out.update(step_ms=v["ms"], loss=v["loss"])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
