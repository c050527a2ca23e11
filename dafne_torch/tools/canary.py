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

The pieces the trained-weight gates (``int8_canary``, ``tta_canary``,
``gen_canary``) share live here too: the CLI's cuDNN settings
(``cli_backend_flags``), the record's card fields (``card_fields``), the
model built and trained as the CLI does it (``train_recipe``), the overfit
gates' config (``gate_recipe``), and the gate command line and its record
(``gate_parser``, ``report``, ``gate_main``).
"""

from __future__ import annotations

import argparse
import contextlib
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


@contextlib.contextmanager
def cli_backend_flags():
    """The CLI process's cuDNN and TF32 settings for the block, the caller's
    restored after it: cuDNN's benchmark off, TF32 in cuDNN's convs, none in
    cuBLAS's matmuls (PyTorch's defaults, which ``tools/train.py`` leaves
    as they are).  Under the benchmark cuDNN picks its algorithms by the
    clock, and the canary's mAP moved from run to run."""
    import torch

    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = False, True, False
    try:
        yield
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def card_fields(device) -> dict:
    """A gate record's "device" (the card's name, or "cpu"), "power_limit"
    (nvidia-smi's, None on the CPU) and "torch" (its version).  nvidia-smi
    numbers the cards apart from CUDA_VISIBLE_DEVICES, so the card's row is
    found by its UUID."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None, "torch": torch.__version__}
    index = device.index if device.index is not None else torch.cuda.current_device()

    def bare(uuid):
        return str(uuid).strip().lower().removeprefix("gpu-")

    rows = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    limits = {bare(uuid): limit.strip() for uuid, limit in (r.split(",", 1) for r in rows)}
    return {"device": torch.cuda.get_device_name(index),
            "power_limit": limits[bare(torch.cuda.get_device_properties(index).uuid)],
            "torch": torch.__version__}


def gate_parser(doc: str, out) -> argparse.ArgumentParser:
    """A gate tool's command line: --out (the record's path), --cpu and
    trailing KEY VALUE overrides."""
    p = argparse.ArgumentParser(description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=out, help="the record's path")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    return p


def report(record: dict, path: str) -> int:
    """Write a gate's record as indented JSON at `path`, print it as one
    line, and return the exit code: 1 when a check failed."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return 0 if record["ok"] else 1


def gate_recipe(overrides, opts=()):
    """An overfit gate's config: RECIPE, the gate's `overrides`,
    SOLVER.MAX_ITER from CANARY_ITERS (default 800), then `opts`."""
    from dafne_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, RECIPE))
    cfg.merge_from_list(list(overrides) + ["SOLVER.MAX_ITER", os.environ.get("CANARY_ITERS", "800")]
                        + list(opts))
    return cfg


def gate_main(argv, doc: str, out: str, run) -> int:
    """An overfit gate's ``main``: parse `argv` (``gate_parser``), call
    `run(opts, device)` and ``report`` its record at --out."""
    a = gate_parser(doc, out).parse_args(argv)
    return report(run(a.opts, "cpu" if a.cpu else "cuda"), a.out)


def train_recipe(cfg, device, resume: bool = False):
    """The model of `cfg` built as the CLI builds it (SEED, or 0, seeds its
    weights) on `device` and trained by ``do_train`` over DATASETS.TRAIN, from
    OUTPUT_DIR's newest checkpoint when `resume`.  Returns (the model in eval
    mode, the train records, seconds of making the records and training)."""
    import torch

    from dafne_torch.data import get_dataset
    from dafne_torch.engine.train_loop import default_setup, do_train
    from dafne_torch.models import build_model

    default_setup(cfg)
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(max(cfg.SEED, 0)))
    t0 = time.perf_counter()
    records = [r for name in cfg.DATASETS.TRAIN for r in get_dataset(name, cfg)]
    do_train(cfg, model, records, resume=resume)
    return model.eval(), records, time.perf_counter() - t0


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
