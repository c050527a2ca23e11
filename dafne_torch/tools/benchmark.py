"""Benchmark harness: data, train and eval throughput of a recipe.

    python -m dafne_torch.tools.benchmark --config-file configs/dota-1.0/1024.yaml \
        --task eval|train|data [--iters 100] [--warmup 5] [--batch-size N] [--cpu] [KEY VALUE ...]

Counterpart of ``tools/benchmark.py`` (its JSON fields, and more):

- ``data``: the train loader with the recipe's buckets and train-time
  augmentation (rendered on the device when ``resolve_train_device_aug``
  says so, as the train loop does): img/s of batches drawn on the host.
- ``train``: the recipe's train steps on batches cached on the device (one
  step per canvas of the bucket ladder, ``TPU.BUCKETED_TRAIN``): img/s and
  step ms over the cycled batches, and for a bucketed recipe each canvas
  timed alone (``per_canvas_ms``) and their mean weighted by the recipe's
  scale distribution (``expected_step_ms``).
- ``eval``: the eval step at the config's test canvas on random images:
  ``latency_ms`` per batch and img/s.

Times are the host clock around work that ends in
``torch.cuda.synchronize()``, under the CLI's cuDNN settings (benchmark
off, ``canary.cli_backend_flags``).  ``mfu`` (train and eval) is the
FLOPs of the timed steps (``analyze_model.count_work``: convolutions and
matrix products, the backward included) over their time at the card's
bf16 peak, "not measured" off the card.  Runs on the card unless ``--cpu``
is given.  Prints one JSON line with the task's fields, "batch_size",
"device" (the card's name, or "cpu"), "power_limit" and "cudnn".
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_records(cfg):
    from dafne_torch.data import get_dataset

    return list(itertools.chain(*(get_dataset(n, cfg) for n in cfg.DATASETS.TRAIN)))


def canvas_probs(buckets) -> dict:
    """{canvas: probability} under the recipe's scale distribution (JAX
    :205-217): each scale of the list, or each integer of a "range", once."""
    if buckets.sampling == "range":
        lo, hi = buckets.sizes
        draws = [buckets.canvas_for(s) for s in range(int(lo), int(hi) + 1)]
    else:
        draws = [buckets.canvas_for(s) for s in buckets.sizes]
    return {hw: draws.count(hw) / len(draws) for hw in set(draws)}


def bench_data(cfg, args, device) -> dict:
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import pad_target_hw, train_canvas_buckets
    from dafne_torch.engine.trainer import resolve_train_device_aug

    records = train_records(cfg)
    bs = cfg.SOLVER.IMS_PER_BATCH
    loader = DataLoader(cfg, records, bs, seed=max(cfg.SEED, 0),
                        pad_hw=pad_target_hw(cfg, train=True),
                        buckets=train_canvas_buckets(cfg, records),
                        device_aug=resolve_train_device_aug(cfg))
    it = iter(loader)
    try:
        for _ in range(args.warmup):
            next(it)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return {"task": "data", "img_per_s": bs * args.iters / dt, "device_aug": loader.device_aug}


def bench_train(cfg, args, device) -> dict:
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import pad_target_hw, train_canvas_buckets
    from dafne_torch.engine.optimizer import build_optimizer
    from dafne_torch.engine.train_loop import batch_canvas_hw, to_device
    from dafne_torch.engine.trainer import make_train_step, resolve_train_device_aug
    from dafne_torch.tools.analyze_model import build, count_work
    from dafne_torch.tools.train_step_profile import mfu

    bs = cfg.SOLVER.IMS_PER_BATCH
    records = train_records(cfg)
    buckets = train_canvas_buckets(cfg, records)
    model = build(cfg, device, max(cfg.SEED, 0))
    optimizer, scheduler = build_optimizer(cfg, model)
    model.train()
    loader = DataLoader(cfg, records, bs, seed=max(cfg.SEED, 0),
                        pad_hw=pad_target_hw(cfg, train=True), buckets=buckets,
                        pin_memory=torch.device(device).type == "cuda",
                        device_aug=resolve_train_device_aug(cfg))
    steps, flops = {}, {}

    def get_step(hw):
        if hw not in steps:
            steps[hw] = make_train_step(model, cfg, hw, optimizer, scheduler,
                                        device_aug=loader.device_aug)
        return steps[hw]

    it = iter(loader)
    try:
        # batches cached on the device; enough to cover the ladder when bucketed
        n_stage = 8 if buckets is None else max(8, 3 * len(buckets.canvases))
        batches = [(batch_canvas_hw(b), to_device(b, device)) for b in itertools.islice(it, n_stage)]
        first_of = {hw: b for hw, b in reversed(batches)}
        probs = canvas_probs(buckets) if buckets is not None else {}
        for _ in range(100):  # every probable canvas gets a staged batch
            if all(hw in first_of for hw in probs):
                break
            b = next(it)
            first_of.setdefault(batch_canvas_hw(b), to_device(b, device))
    finally:
        it.close()
    for hw, b in first_of.items():  # build each canvas's step, and count its work
        get_step(hw)(b)
        flops[hw] = count_work(lambda: get_step(hw)(b))[0]["flops"]
    for i in range(args.warmup):
        hw, b = batches[i % len(batches)]
        get_step(hw)(b)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        hw, b = batches[i % len(batches)]
        get_step(hw)(b)
    _sync(device)
    dt = time.perf_counter() - t0
    step_flops = sum(flops[batches[i % len(batches)][0]] for i in range(args.iters))
    result = {"task": "train", "img_per_s": bs * args.iters / dt,
              "step_ms": dt / args.iters * 1000, "bucketed": buckets is not None,
              "device_aug": loader.device_aug,
              "canvases": [list(c) for c in sorted({hw for hw, _ in batches})],
              "flops_per_step_g": step_flops / args.iters / 1e9,
              "mfu": mfu(step_flops, dt * 1000, device)}
    if buckets is not None:
        # each canvas timed alone, and the mean under the scale distribution
        per_canvas = {}
        for hw, b in first_of.items():
            step = get_step(hw)
            for _ in range(2):
                step(b)
            _sync(device)
            reps = max(10, args.iters // 4)
            t0 = time.perf_counter()
            for _ in range(reps):
                step(b)
            _sync(device)
            per_canvas[hw] = (time.perf_counter() - t0) / reps * 1000
        result["per_canvas_ms"] = {f"{h}x{w}": v for (h, w), v in per_canvas.items()}
        result["canvas_probs"] = {f"{h}x{w}": p for (h, w), p in probs.items()}
        result["expected_step_ms"] = (sum(p * per_canvas[hw] for hw, p in probs.items())
                                      if all(hw in per_canvas for hw in probs) else None)
    return result


def bench_eval(cfg, args, device) -> dict:
    from dafne_torch.data.mapper import pad_target_hw
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.tools.analyze_model import build, count_work
    from dafne_torch.tools.train_step_profile import mfu

    bs = cfg.SOLVER.IMS_PER_BATCH
    model = build(cfg, device, max(cfg.SEED, 0))
    pad_hw = pad_target_hw(cfg, train=False)
    eval_step = make_eval_step(model, cfg, pad_hw)
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.rand(bs, *pad_hw, 3).astype(np.float32) * 255).to(device)
            for _ in range(4)]
    flops = count_work(lambda: eval_step(imgs[0]))[0]["flops"]
    for i in range(args.warmup):
        eval_step(imgs[i % 4])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        eval_step(imgs[i % 4])
    _sync(device)
    dt = time.perf_counter() - t0
    return {"task": "eval", "img_per_s": bs * args.iters / dt,
            "latency_ms": dt / args.iters * 1000, "pad_hw": list(pad_hw),
            "flops_per_batch_g": flops / 1e9,
            "mfu": mfu(flops, dt / args.iters * 1000, device)}


def run(cfg, args, device: str) -> dict:
    """The task's record (printed by ``main``)."""
    from dafne_torch.data import register_all_datasets
    from dafne_torch.tools.canary import card_fields, cli_backend_flags

    register_all_datasets(cfg)
    with cli_backend_flags():
        cudnn = {"benchmark": torch.backends.cudnn.benchmark,
                 "allow_tf32": torch.backends.cudnn.allow_tf32,
                 "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        result = {"data": bench_data, "train": bench_train, "eval": bench_eval}[args.task](
            cfg, args, device)
    result["batch_size"] = cfg.SOLVER.IMS_PER_BATCH
    result.update(card_fields(device))
    result["cudnn"] = cudnn
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--task", choices=["data", "train", "eval"], default="eval")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=0, help="override SOLVER.IMS_PER_BATCH")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from dafne_torch.tools.analyze_model import load_cfg, resolve_device

    args = parse_args(argv)
    cfg = load_cfg(args.config_file, args.opts)
    if args.batch_size:
        cfg.SOLVER.IMS_PER_BATCH = args.batch_size
    cfg.SOLVER.REFERENCE_WORLD_SIZE = 0
    print(json.dumps(run(cfg, args, resolve_device(args.cpu))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
