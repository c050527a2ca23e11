"""Train the synthetic canary recipe several times and report each run's mAP.

    python -m dafne_torch.tools.canary [--runs 4] [--seeds 0,1,2,3]
        [--deterministic | --cudnn-benchmark] [--out output/canary] [--cpu]
        [KEY VALUE ...]

The bf16 half of ``tools/int8_canary.py``: ``configs/synthetic/base.yaml``
with the canary's overrides (DEBUG.OVERFIT_NUM_IMAGES 32, SOLVER.MAX_ITER
800, DATASETS.TEST ('synthetic_train',)) trained through the port's CLI
and evaluated on the 32 scenes it trained on.  Each run is a process of
its own on the one card, all started together, each in OUTPUT_DIR
<out>/run<i>; --seeds sets SEED per run (default: the recipe's own for
every run, so that runs differ only by the card's rounding).
--deterministic runs each process with ``torch.use_deterministic_algorithms``
(cuDNN's deterministic algorithms, cuBLAS's fixed workspace), so that a
seed gives one result.  --cudnn-benchmark lets cuDNN time its algorithms
and keep the fastest (``torch.backends.cudnn.benchmark``), which the CLI
leaves off: which algorithm wins, and so how each conv rounds, can change
from run to run.  Trailing KEY VALUE pairs override the config (for
a short run on the CPU: ``--cpu SOLVER.MAX_ITER 2``).

Prints one line per run (bf16 mAP; mean total loss of the first and last
20 steps; the largest loss after the warm-up and its step; train seconds)
and then one JSON object with every run and the spread of the mAPs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECIPE = "configs/synthetic/base.yaml"
#: tools/int8_canary.py:46-66; MAP_GATE is its convergence gate (:14-15)
CANARY_OPTS = ["DEBUG.OVERFIT_NUM_IMAGES", "32", "SOLVER.MAX_ITER", "800",
               "DATASETS.TEST", "('synthetic_train',)"]
MAP_GATE = 50.0


def make_deterministic() -> None:
    """Deterministic kernels for everything this process runs on the card
    from here on.  cuBLAS reads CUBLAS_WORKSPACE_CONFIG when it starts, so
    this comes before the first matrix product."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def loss_summary(losses, warmup: int) -> dict:
    """The mean total loss of the first and last 20 steps, and the largest
    loss after `warmup` steps with its (1-based) step."""
    tail = losses[warmup:] or losses
    top = max(range(len(tail)), key=tail.__getitem__)
    return {"first20": statistics.fmean(losses[:20]), "last20": statistics.fmean(losses[-20:]),
            "max_after_warmup": tail[top], "max_step": top + 1 + (len(losses) - len(tail))}


def run_one(out_dir: str, deterministic: bool, cudnn_benchmark: bool, cpu: bool, opts) -> dict:
    """One canary run in this process: train, evaluate, summarize."""
    import torch

    if deterministic:
        make_deterministic()
    torch.backends.cudnn.benchmark = cudnn_benchmark
    from dafne_torch.tools.train import main as cli_main

    args = (["--config-file", os.path.join(ROOT, RECIPE)] + CANARY_OPTS + list(opts)
            + ["OUTPUT_DIR", out_dir])
    train_stats = {}
    t0 = time.perf_counter()
    res = cli_main((["--cpu"] if cpu else []) + args, train_stats=train_stats)
    train_s = time.perf_counter() - t0
    ((_, st),) = train_stats["steps"].items()
    from dafne_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, RECIPE))
    cfg.merge_from_list(args[2:])
    return {"mAP": res["synthetic_train"]["mAP"], "train_s": train_s, "steps": len(st["loss"]),
            "deterministic": deterministic, "cudnn_benchmark": cudnn_benchmark, "seed": cfg.SEED,
            **loss_summary(st["loss"], cfg.SOLVER.WARMUP_ITERS)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--seeds", default="", help="comma-separated SEED per run")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--deterministic", action="store_true")
    mode.add_argument("--cudnn-benchmark", action="store_true")
    p.add_argument("--out", default=os.path.join(ROOT, "output", "canary"))
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    a = p.parse_args(argv)
    if a.one:  # a child: one run, its summary as the last line
        r = run_one(a.out, a.deterministic, a.cudnn_benchmark, a.cpu, a.opts)
        print(json.dumps(r), flush=True)
        return 0
    seeds = [s for s in a.seeds.split(",") if s] or [None] * a.runs
    if not a.cpu:  # build the kernels once, before the runs share the build directory
        from dafne_torch.ops.kernels import build as kbuild

        for name in ("quad_nms", "assign"):
            kbuild.build(name)
    procs = []
    for i, seed in enumerate(seeds):
        out = os.path.join(a.out, f"run{i}")
        os.makedirs(out, exist_ok=True)
        cmd = [sys.executable, "-m", "dafne_torch.tools.canary", "--one", "--out", out]
        cmd += (["--deterministic"] * a.deterministic + ["--cudnn-benchmark"] * a.cudnn_benchmark
                + ["--cpu"] * a.cpu)
        cmd += list(a.opts) + ([] if seed is None else ["SEED", seed])
        log = open(os.path.join(out, "canary.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=log,
                                       text=True), log))
    runs = []
    for i, (proc, log) in enumerate(procs):
        out, _ = proc.communicate()
        log.close()
        if proc.returncode != 0:
            print(f"run {i}: exit {proc.returncode}; see {log.name}", file=sys.stderr)
            runs.append({"exit": proc.returncode})
            continue
        r = json.loads(out.strip().splitlines()[-1])
        runs.append(r)
        print(f"run {i} (seed {r['seed']}, deterministic {r['deterministic']}, cudnn benchmark "
              f"{r['cudnn_benchmark']}): bf16 mAP "
              f"{r['mAP']:.2f}; loss first/last 20 steps {r['first20']:.4f} -> "
              f"{r['last20']:.4f}, largest after the warm-up {r['max_after_warmup']:.4f} at step "
              f"{r['max_step']}; {r['train_s']:.1f} s", flush=True)
    maps = [r["mAP"] for r in runs if "mAP" in r]
    print(json.dumps({"recipe": RECIPE, "runs": runs, "gate": MAP_GATE,
                      "above_gate": sum(m > MAP_GATE for m in maps), "maps": maps,
                      "min": min(maps, default=None), "max": max(maps, default=None)}))
    return 0 if len(maps) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
