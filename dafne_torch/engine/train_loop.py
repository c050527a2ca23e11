"""The training loop: records -> loader -> train steps -> metric writers.

Counterpart of ``dafne_tpu/engine/train_loop.py::do_train`` (:288) for one
GPU: ``auto_scale_config`` to a world size of 1, the train records through
the port's loader onto the static train canvas, SOLVER.MAX_ITER steps, the
metric writers every 20 iterations (and at the first), and the
``DEBUG.NAN_CHECK`` raise.  Checkpoints, periodic evaluation, several
processes and the profiler window are not ported.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import pad_target_hw
from dafne_torch.engine.events import build_writers
from dafne_torch.engine.optimizer import auto_scale_config, build_optimizer
from dafne_torch.engine.trainer import make_train_step

logger = logging.getLogger("dafne_torch")

WRITE_PERIOD = 20


def to_device(batch, device) -> Dict:
    """The step's tensors of a loader batch, copied without blocking."""
    return {k: batch[k].to(device, non_blocking=True) for k in ("image",) + GT_KEYS}


def do_train(cfg, model, records: List[dict]) -> Dict[str, float]:
    """Train `model` (on its device) over `records` (dicts with "image" and
    "annotations") for SOLVER.MAX_ITER steps.  Returns the metrics of the
    last write, as floats."""
    cfg = auto_scale_config(cfg, 1)
    device = next(model.parameters()).device
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    pad_hw = pad_target_hw(cfg, train=True)
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    max_iter = cfg.SOLVER.MAX_ITER
    logger.info(f"device={device} batch={batch_size} pad_hw={pad_hw} records={len(records)}")

    optimizer, scheduler = build_optimizer(cfg, model)
    step = make_train_step(model, cfg, pad_hw, optimizer, scheduler)
    loader = DataLoader(cfg, records, batch_size, seed=max(cfg.SEED, 0), pad_hw=pad_hw,
                        pin_memory=device.type == "cuda")
    writers = build_writers(cfg.OUTPUT_DIR, max_iter)
    model.train()
    batches = iter(loader)
    host: Dict[str, float] = {}
    t_data = 0.0
    last_write = -1
    try:
        for it in range(max_iter):
            t0 = time.perf_counter()
            batch = to_device(next(batches), device)
            t_data += time.perf_counter() - t0
            metrics = step(batch)
            if (it + 1) % WRITE_PERIOD == 0 or it == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["data_time"] = t_data / (it - last_write)
                last_write = it
                t_data = 0.0
                if cfg.DEBUG.NAN_CHECK and not host["loss_is_finite"]:
                    raise FloatingPointError(f"Loss became non-finite at iteration {it}: {host}")
                for w in writers:
                    w.write(it + 1, host)
    finally:
        batches.close()
        for w in writers:
            w.close()
    return host
