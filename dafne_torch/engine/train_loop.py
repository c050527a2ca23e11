"""The training and evaluation loops.

Counterpart of ``dafne_tpu/engine/train_loop.py``, on one device per
process:

- ``do_train`` (:288): ``auto_scale_config`` to the world size (:296),
  resume or bootstrap through ``engine/checkpoint.py``, the train records
  through the port's loader onto the static train canvas, or with a
  multi-scale ladder onto each batch's bucket canvas (``TrainScaleBuckets``,
  TPU.BUCKETED_TRAIN, :300-345: one train step per canvas, built on first
  use, all sharing the model, optimizer and scheduler), rendered on the
  device when ``resolve_train_device_aug`` says so (:331-372), SOLVER.MAX_ITER steps,
  the metric writers every 20 iterations (and at the first), the
  ``DEBUG.NAN_CHECK`` raise, an asynchronous checkpoint
  (``Checkpointer.save_async``, :494,501) every SOLVER.CHECKPOINT_PERIOD
  iterations and at the end, and ``do_test`` every TEST.EVAL_PERIOD, after
  the queued saves are written.  ``DEBUG.PROFILE_ITERS`` [start, stop]
  (:395-401,463-469,499-501) runs ``torch.profiler`` over the CPU and the
  card from the top of iteration `start` to the top of `stop` (or the
  loop's end) and writes a Chrome trace to
  OUTPUT_DIR/profile/trace_<start>-<stop>.json; a resume past `start`
  traces nothing.
- ``do_test`` (:108): every DATASETS.TEST dataset through the eval loader
  and ``make_eval_step`` on the tight eval canvas, one batch in flight
  while the host fetches the previous one, into the VOC-07 evaluator;
  ``results.txt``, the Task1 files and ``test_results.csv``.  An unlabeled
  test split (:225-242) gets no AP: its Task1 files go to ``task1/``, and
  for DOTA the cross-tile merge to ``task1_merged/`` and
  ``submission.zip`` (``evaluation/result_merge.py``).
- ``save_test_results``, ``setup_logging`` and ``default_setup``.

With several processes (``parallel/distributed.py``) SOLVER.IMS_PER_BATCH
and TPU.EVAL_BATCH are global batches: each process maps, trains on and
evaluates its rows of them.  The parameters, and TPU.TRAIN_DEVICE_AUG's
decision (its "auto" reads the host's cores), are broadcast from process 0
at the start; process 0 alone writes the metrics, the config, the
checkpoints, the profiler trace and the evaluation files, and the decoded
detections of every process's rows are gathered to it through the host.
The others return ``{}`` per dataset from ``do_test``, as JAX's do.

Sample renderings are not ported.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from dafne_torch.data import get_dataset, register_all_datasets
from dafne_torch.data.loader import GT_KEYS, DataLoader
from dafne_torch.data.mapper import eval_pad_hw, pad_target_hw, train_canvas_buckets
from dafne_torch.data.registry import MetadataCatalog
from dafne_torch.engine.checkpoint import Checkpointer
from dafne_torch.engine.events import build_writers, elapsed_ms, mark
from dafne_torch.engine.inference import make_eval_step
from dafne_torch.engine.optimizer import auto_scale_config, build_optimizer
from dafne_torch.engine.trainer import make_train_step, resolve_train_device_aug
from dafne_torch.evaluation import build_evaluator
from dafne_torch.evaluation.result_merge import make_submission_zip, merge_by_poly
from dafne_torch.ops.device_warp import WARP_KEYS
from dafne_torch.parallel import distributed as dist
from dafne_torch.parallel.mesh import mesh_from_config

logger = logging.getLogger("dafne_torch")

WRITE_PERIOD = 20
# what a device-aug batch ships in place of "image" (engine/trainer.py::device_aug_image)
DEVICE_AUG_KEYS = (("image_base", "aug_out_hw") + tuple("aug_" + k for k in WARP_KEYS)
                   + ("color_light", "color_w"))


def batch_canvas_hw(batch) -> Tuple[int, int]:
    """The canvas a train batch renders at: its images' on the host path,
    its warp taps' on the device-aug path (JAX ``_batch_canvas_hw``)."""
    if "image" in batch:
        return tuple(batch["image"].shape[1:3])
    return batch["aug_idx0_h"].shape[1], batch["aug_idx0_w"].shape[1]


def to_device(batch, device) -> Dict:
    """The step's tensors of a loader batch, copied without blocking:
    "image", or a device-aug batch's base images and vectors, and the gts."""
    keys = ("image",) if "image" in batch else tuple(k for k in DEVICE_AUG_KEYS if k in batch)
    return {k: batch[k].to(device, non_blocking=True) for k in keys + GT_KEYS}


def setup_logging(output_dir=None, file_name="log.txt"):
    handlers = [logging.StreamHandler()]
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, file_name)))
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s %(name)s] %(message)s",
                        handlers=handlers, force=True)


def default_setup(cfg):
    """Logging to OUTPUT_DIR/log.txt (log.txt.rank<r> for process r > 0),
    the datasets registered, and the config written to
    OUTPUT_DIR/config.yaml by process 0."""
    rank = dist.process_index()
    setup_logging(cfg.OUTPUT_DIR, "log.txt" if rank == 0 else f"log.txt.rank{rank}")
    register_all_datasets(cfg)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    if rank == 0:
        cfg.dump_to_file(os.path.join(cfg.OUTPUT_DIR, "config.yaml"))


def _fetch_async(det: Dict[str, torch.Tensor]):
    """Start copying a step's detections to the host: (tensors, event), the
    tensors readable once the event (None off the card) has completed."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in det.items()}
    event = None
    if any(v.is_cuda for v in det.values()):
        event = torch.cuda.Event()
        event.record()
    return host, event


def _consume(evaluator, batch, fetched) -> int:
    """Feed a fetched batch's detections to `evaluator` (None off process
    0: its rows go to process 0's) and count the batch's valid images."""
    host, event = fetched
    if event is not None:
        event.synchronize()
    det = dist.gather_to_main({k: v.numpy() for k, v in host.items()})
    if evaluator is not None:
        evaluator.process_batch(batch, det)
    return int(batch["batch_valid"].sum())


def do_test(cfg, model, output_dir=None, step: int = 0,
            stats: Optional[dict] = None) -> Dict[str, Dict[str, float]]:
    """Evaluate `model` (on its device) on every cfg.DATASETS.TEST dataset.

    Returns {dataset: {"AP50/<class>": ..., "mAP": ...}} on process 0 and
    {dataset: {}} on the others.  With
    `output_dir`, each dataset's artifacts go to
    output_dir/inference/<dataset> and a row per metric is appended to
    output_dir/test_results.csv.  A `stats` dict receives, per dataset, the
    images evaluated, the host seconds of the loop (model, decode, fetch)
    and of ``evaluate()`` (on an unlabeled test split: of writing the
    Task1 files, of the merge and of the zip instead), and the per-image
    detections ("preds": image id to corners, scores, classes).  The model
    is left in the mode it came in.  With several processes TPU.EVAL_BATCH
    is rounded down to a multiple of the world size (at least one row
    each); process 0 evaluates, writes and fills `stats` with "preds"."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    results = {}
    pc, main = dist.process_count(), dist.is_main_process()
    batch_size = max(1, int(cfg.TPU.EVAL_BATCH))
    if pc > 1:  # the global eval batch splits evenly over the data axis (the processes)
        q = mesh_from_config(cfg)["data"]
        batch_size = max(q, batch_size // q * q)
    for dataset_name in cfg.DATASETS.TEST:
        records = get_dataset(dataset_name, cfg)
        meta = MetadataCatalog.get(dataset_name, {})
        unlabeled = meta.get("is_test") and not any(r.get("annotations") for r in records)
        # the tight per-dataset canvas (record dims) instead of MAX_SIZE_TEST^2
        pad_hw = eval_pad_hw(cfg, records)
        eval_step = make_eval_step(model, cfg, pad_hw)
        loader = DataLoader(cfg, records, batch_size, pad_hw=pad_hw,
                            pin_memory=device.type == "cuda", train=False,
                            process_index=dist.process_index(), process_count=pc)
        out_dir = os.path.join(output_dir, "inference", dataset_name) if output_dir else None
        evaluator = build_evaluator(cfg, dataset_name, records, out_dir) if main else None
        t0 = time.perf_counter()
        n_images = 0
        # one batch in flight: batch i+1 is dispatched (its host mapping
        # overlapping batch i on the device) before batch i is fetched
        pending = None
        for batch in loader:
            det = eval_step(batch["image"].to(device, non_blocking=True),
                            batch["scale_xy"].to(device, non_blocking=True))
            fetched = _fetch_async(det)
            if pending is not None:
                n_images += _consume(evaluator, *pending)
            pending = (batch, fetched)
        if pending is not None:
            n_images += _consume(evaluator, *pending)
        loop_s = time.perf_counter() - t0
        if not main:
            results[dataset_name] = {}
            if stats is not None:
                stats[dataset_name] = {"images": n_images, "loop_s": loop_s}
            continue
        t0 = time.perf_counter()
        if unlabeled:
            res, split = {}, _write_submission(evaluator, meta, out_dir)
        else:
            res, split = evaluator.evaluate(), {}
        evaluate_s = time.perf_counter() - t0
        if out_dir and cfg.TEST.NUM_PRED_VIS > 0:
            logger.info(f"TEST.NUM_PRED_VIS={cfg.TEST.NUM_PRED_VIS}: sample renderings are not "
                        "ported (they need cv2); none written")
        logger.info(f"eval {dataset_name}: {n_images} images in {loop_s:.3f} s "
                    f"({n_images / max(loop_s, 1e-9):.2f} img/s: model, decode, fetch); "
                    + (f"Task1 files, merge and zip {evaluate_s:.3f} s" if unlabeled else
                       f"evaluate {evaluate_s:.3f} s; mAP={res.get('mAP', 0):.2f}"))
        results[dataset_name] = res
        if stats is not None:
            stats[dataset_name] = {"images": n_images, "loop_s": loop_s,
                                   "evaluate_s": evaluate_s, "preds": evaluator._preds, **split}
        if output_dir and res:
            save_test_results(output_dir, dataset_name, step, res)
    model.train(was_training)
    return results


def _write_submission(evaluator, meta, out_dir) -> Dict[str, float]:
    """An unlabeled test split's files under `out_dir` (none without it):
    the Task1 files in task1/ and, for DOTA, their cross-tile merge in
    task1_merged/ and submission.zip.  Returns the host seconds of each."""
    if not out_dir:
        return {}
    split = {}
    t0 = time.perf_counter()
    task1 = os.path.join(out_dir, "task1")
    evaluator.write_task1_files(task1)
    split["task1_s"] = time.perf_counter() - t0
    if meta.get("evaluator_type") == "dota":
        t0 = time.perf_counter()
        merged = os.path.join(out_dir, "task1_merged")
        merge_by_poly(task1, merged)
        split["merge_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zp = make_submission_zip(merged, os.path.join(out_dir, "submission.zip"))
        split["zip_s"] = time.perf_counter() - t0
        logger.info(f"wrote submission {zp}")
    return split


def save_test_results(output_dir, dataset_name, step, res):
    """Append one row per metric to output_dir/test_results.csv."""
    path = os.path.join(output_dir, "test_results.csv")
    exists = os.path.exists(path)
    with open(path, "a") as f:
        w = csv.writer(f)
        if not exists:
            w.writerow(["iteration", "dataset", "metric", "value"])
        for k, v in sorted(res.items()):
            w.writerow([step, dataset_name, k, f"{v:.4f}"])


class ProfileWindow:
    """``DEBUG.PROFILE_ITERS`` [start, stop] of one process: ``at(it)`` at
    the top of each iteration starts ``torch.profiler`` over the CPU (and
    the card, on one) at `start` and stops it at `stop`, writing the Chrome
    trace; ``close(end)`` stops a window that runs past the loop's end;
    ``abort()`` stops it without a trace.  Only a window that was started
    is ever stopped, and only when `trace` (process 0) is one started."""

    def __init__(self, cfg, device: torch.device, trace: bool = True):
        window = list(cfg.DEBUG.PROFILE_ITERS or [])
        if window and len(window) != 2:
            raise ValueError(f"DEBUG.PROFILE_ITERS must be [start, stop], got {window}")
        self.window = window if trace else []
        self.dir = os.path.join(cfg.OUTPUT_DIR, "profile")
        self.device = device
        self.prof = None
        self.path: Optional[str] = None

    def at(self, it: int) -> None:
        if not self.window:
            return
        if it == self.window[0]:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.start()
        if self.prof is not None and it == self.window[1]:
            self.close(it)

    def close(self, end: int) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self.prof = self.prof, None
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, f"trace_{self.window[0]}-{end}.json")
        prof.export_chrome_trace(self.path)
        logger.info(f"profiler trace of iterations {self.window[0]}-{end} written to {self.path}")

    def abort(self) -> None:
        if self.prof is not None:
            prof, self.prof = self.prof, None
            prof.stop()


def do_train(cfg, model, records: List[dict], resume: bool = False,
             stats: Optional[dict] = None) -> Dict[str, float]:
    """Train `model` (on its device) over `records` (dicts with "image" and
    "annotations") up to SOLVER.MAX_ITER steps, from the newest checkpoint
    of OUTPUT_DIR when `resume`.  Returns the metrics of the last write, as
    floats, and "checkpoint_s": the host seconds spent saving checkpoints.
    A `stats` dict receives the bucket ladder ("canvases", None without
    buckets), and per canvas the train steps built, the milliseconds of
    each step run on it, in order, and each step's total loss ("steps":
    {(h, w): {"builds", "ms", "loss"}}; CUDA events around the step on the
    card, the host clock off it), and per save the loop's and the writer's
    ms ("checkpoints": {"blocking_ms", "worker_ms"}).  With several processes
    SOLVER.IMS_PER_BATCH is the global batch (the loader raises unless it
    splits evenly over them); the returned metrics and the losses in `stats` are global."""
    world, main = dist.process_count(), dist.is_main_process()
    mesh_from_config(cfg)  # a mesh that does not fit the processes raises
    cfg = auto_scale_config(cfg, world)
    device = next(model.parameters()).device
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    pad_hw = pad_target_hw(cfg, train=True)
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    max_iter = cfg.SOLVER.MAX_ITER
    buckets = train_canvas_buckets(cfg, records)
    if buckets is not None:
        logger.info(f"bucketed ms train: canvases {buckets.canvases} (scales {buckets.sizes}, "
                    f"sampling {buckets.sampling})")
    logger.info(f"device={device} batch={batch_size} (process {dist.process_index()} of {world}) "
                f"pad_hw={pad_hw} records={len(records)}")

    optimizer, scheduler = build_optimizer(cfg, model)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    start_iter = checkpointer.resume_or_load(model, cfg, resume, optimizer, scheduler)
    dist.broadcast_state_(model)
    loader = DataLoader(cfg, records, batch_size, seed=max(cfg.SEED, 0), pad_hw=pad_hw,
                        pin_memory=device.type == "cuda",
                        device_aug=dist.broadcast_from_main(resolve_train_device_aug(cfg)),
                        buckets=buckets, process_index=dist.process_index(), process_count=world)
    logger.info(f"train augmentation rendered on the {'device' if loader.device_aug else 'host'}")
    steps: Dict[Tuple[int, int], object] = {}

    def get_step(hw):
        """The train step of canvas `hw`, built on first use (its location
        tables with it)."""
        if hw not in steps:
            steps[hw] = make_train_step(model, cfg, hw, optimizer, scheduler,
                                        device_aug=loader.device_aug)
            per_canvas.setdefault(hw, {"builds": 0, "marks": [], "loss": []})["builds"] += 1
            logger.info(f"train step built for canvas {hw}")
        return steps[hw]

    per_canvas: Dict[Tuple[int, int], dict] = {}
    writers = build_writers(cfg.OUTPUT_DIR, max_iter) if main else []
    window = ProfileWindow(cfg, device, trace=main)
    model.train()
    batches = iter(loader)
    host: Dict[str, float] = {}
    t_data = 0.0
    last_write = start_iter - 1
    ckpt_period, eval_period = cfg.SOLVER.CHECKPOINT_PERIOD, cfg.TEST.EVAL_PERIOD
    blocking_s: List[float] = []  # the loop's seconds per save: snapshot and queue

    def save(at):
        t0 = time.perf_counter()
        checkpointer.save_async(at, model, optimizer, scheduler)
        blocking_s.append(time.perf_counter() - t0)
        logger.info(f"checkpoint {at} queued in {blocking_s[-1]:.3f} s")

    try:
        for it in range(start_iter, max_iter):
            window.at(it)
            t0 = time.perf_counter()
            host_batch = next(batches)
            batch = to_device(host_batch, device)
            t_data += time.perf_counter() - t0
            hw = batch_canvas_hw(host_batch)
            step = get_step(hw)
            if stats is not None:
                start = mark(device)
            metrics = step(batch)
            if stats is not None:
                per_canvas[hw]["marks"].append((start, mark(device)))
                per_canvas[hw]["loss"].append(metrics["loss/total"])
            if (it + 1) % WRITE_PERIOD == 0 or it == start_iter:
                host = {k: float(v) for k, v in metrics.items()}
                host["data_time"] = t_data / (it - last_write)
                last_write = it
                t_data = 0.0
                if cfg.DEBUG.NAN_CHECK and not host["loss_is_finite"]:
                    raise FloatingPointError(f"Loss became non-finite at iteration {it}: {host}")
                for w in writers:
                    w.write(it + 1, host)
            if ckpt_period and (it + 1) % ckpt_period == 0:
                save(it + 1)
            if eval_period and (it + 1) % eval_period == 0 and (it + 1) != max_iter:
                checkpointer.wait()
                do_test(cfg, model, cfg.OUTPUT_DIR, step=it + 1)
        window.close(max_iter)
        save(max_iter)
        checkpointer.wait()
    except BaseException:
        window.abort()
        try:  # the saves queued before the failure are written; the failure propagates
            checkpointer.wait()
        except Exception:
            logger.exception("a checkpoint queued before the failure was not written")
        raise
    finally:
        batches.close()
        for w in writers:
            w.close()
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["canvases"] = buckets.canvases if buckets is not None else None
        stats["steps"] = {hw: {"builds": v["builds"],
                               "ms": [elapsed_ms(a, b) for a, b in v["marks"]],
                               "loss": [float(x) for x in v["loss"]]}
                          for hw, v in per_canvas.items()}
        stats["checkpoints"] = {"blocking_ms": [x * 1e3 for x in blocking_s],
                                "worker_ms": [x * 1e3 for x in checkpointer.worker_s]}
    return {**host, "checkpoint_s": sum(blocking_s),
            "checkpoint_worker_s": sum(checkpointer.worker_s)}
