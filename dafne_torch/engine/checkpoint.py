"""Checkpoints with resume-or-bootstrap semantics.

Counterpart of ``dafne_tpu/engine/checkpoint.py`` (:44-173): a checkpoint
holds the model's, the optimizer's and the LR scheduler's state dicts and
the step, written with ``torch.save`` under ``OUTPUT_DIR/checkpoints`` as
``model_<step>.pth``; the file ``last_checkpoint`` there names the newest,
and the last `max_to_keep` are kept.  ``resume_or_load`` resumes from the
newest checkpoint when asked and one exists, and otherwise loads
MODEL.WEIGHTS when the file exists (:167-171; a ``detectron2://`` URL is
skipped, with a log line): a port ``.pth`` (a checkpoint or a bare model
state dict), or the reference's Detectron2 ``.pkl`` / ``.pth`` through
``utils/weight_import.py``, told apart by their names, not by the file's
extension.  Otherwise the initial weights stay.  Orbax checkpoints of
the JAX package are not read.

``save`` writes at once.  ``save_async`` (:88-131) costs the caller only a
snapshot on the device, a clone of every state tensor on the current
stream with a CUDA event recorded after it; one worker thread waits on
that event, copies the snapshot to the host, writes it and applies
`max_to_keep`, one save after another in call order.  Both write the
state's tensors from the host, so their files are equal.  A worker's failure
is raised by the next ``save_async`` or ``wait``.  Every file is written
under a temporary name and renamed, and ``last_checkpoint`` moves after
it, so ``resume_or_load`` and ``latest_step`` never see half a file.
With several processes process 0 writes and all meet at a barrier after
``save`` and after ``wait``, and each resumes from the same file onto its
own device: every process holds the same state, so a checkpoint of any
world size resumes under any other.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, List, Optional

import torch

from dafne_torch.parallel.distributed import barrier, is_main_process
from dafne_torch.utils import weight_import

LAST = "last_checkpoint"
logger = logging.getLogger("dafne_torch")


def _map_tensors(obj, fn: Callable):
    """`obj` (nested dicts, lists and tuples) with `fn` applied to each tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _payload(step, model, optimizer, scheduler) -> dict:
    payload = {"model": model.state_dict(), "step": int(step)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if scheduler is not None:
        payload["scheduler"] = scheduler.state_dict()
    return payload


class Checkpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._queued = False  # save_async called since the last wait (on every process)
        self.worker_s: List[float] = []  # the worker's seconds per save: wait, copy, write

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"model_{step:07d}.pth")

    def save(self, step: int, model, optimizer=None, scheduler=None) -> str:
        """Write the checkpoint of `step` (atomically: a reader never sees
        half a file) and point ``last_checkpoint`` at it, on process 0, then
        meet the other processes.  Saves still queued are written first.
        Returns its path."""
        self.wait()
        path = self._path(step)
        if is_main_process():
            self._write(path, _map_tensors(_payload(step, model, optimizer, scheduler),
                                           lambda t: t.detach().to("cpu")))
        barrier()
        return path

    def save_async(self, step: int, model, optimizer=None, scheduler=None) -> str:
        """Queue the checkpoint of `step` on process 0 (the others do
        nothing): a clone of every state tensor on its device, and a CUDA
        event after the clones when any is on the card; the worker thread
        copies and writes it.  Raises a failure of an earlier save.
        Returns its path."""
        self._raise_pending()
        path = self._path(step)
        self._queued = True
        if not is_main_process():
            return path
        snap = _map_tensors(_payload(step, model, optimizer, scheduler),
                            lambda t: t.detach().clone())
        event = None
        if any(p.is_cuda for p in model.parameters()):
            event = torch.cuda.Event()
            event.record()
        if self._worker is None:
            self._worker = threading.Thread(target=self._work, name="checkpoint-writer",
                                            daemon=True)
            self._worker.start()
        self._queue.put((path, snap, event))
        return path

    def wait(self) -> None:
        """Wait until every queued save is written and stop the worker, then
        meet the other processes; raise a worker's failure."""
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
        if self._queued:
            self._queued = False
            barrier()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint save failed") from err

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            path, snap, event = item
            t0 = time.perf_counter()
            try:
                if event is not None:
                    event.synchronize()
                self._write(path, _map_tensors(snap, lambda t: t.to("cpu")))
            except BaseException as e:  # raised by the next save_async or wait
                self._error = e
            self.worker_s.append(time.perf_counter() - t0)

    def _write(self, path, payload) -> None:
        torch.save(payload, f"{path}.tmp")
        os.replace(f"{path}.tmp", path)
        with open(os.path.join(self.dir, f"{LAST}.tmp"), "w") as f:
            f.write(os.path.basename(path))
        os.replace(os.path.join(self.dir, f"{LAST}.tmp"), os.path.join(self.dir, LAST))
        saved = sorted(p for p in os.listdir(self.dir) if p.startswith("model_") and p.endswith(".pth"))
        for old in saved[: max(len(saved) - self.max_to_keep, 0)]:
            os.remove(os.path.join(self.dir, old))

    def latest_step(self) -> Optional[int]:
        """The step of the checkpoint ``last_checkpoint`` names, or None."""
        try:
            with open(os.path.join(self.dir, LAST)) as f:
                name = f.read().strip()
        except FileNotFoundError:
            return None
        return int(name[len("model_"): -len(".pth")])

    def restore(self, model, optimizer=None, scheduler=None) -> int:
        """Load the newest checkpoint into `model` (and the optimizer and
        scheduler when given and saved).  Returns its step, 0 when there is
        none."""
        step = self.latest_step()
        if step is None:
            return 0
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        model.load_state_dict(payload["model"])
        if optimizer is not None and "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
        if scheduler is not None and "scheduler" in payload:
            scheduler.load_state_dict(payload["scheduler"])
        return int(payload["step"])

    def resume_or_load(self, model, cfg, resume: bool, optimizer=None, scheduler=None) -> int:
        """Resume from OUTPUT_DIR when `resume` and a checkpoint exists;
        else load MODEL.WEIGHTS into the model when the file exists.
        Returns the step to start from."""
        if resume and self.latest_step() is not None:
            return self.restore(model, optimizer, scheduler)
        weights = cfg.MODEL.WEIGHTS
        if weights and os.path.exists(weights):
            load_weights(model, weights)
        elif weights:
            logger.info(f"MODEL.WEIGHTS {weights} is not a file here; keeping the initial weights")
        return 0


def load_weights(model, path: str) -> None:
    """Load a weights file into `model`: the port's own state dict (a
    checkpoint's "model", or bare) strictly, or a Detectron2 / MSRA
    ``.pkl`` or ``.pth`` through the importer.  ``torch.save`` files load
    with ``weights_only=True``; only a ``.pkl`` goes through pickle
    (``weight_import.read_weights_file``)."""
    payload = weight_import.read_weights_file(path)
    sd = payload.get("model", payload)
    if weight_import.looks_like_reference(sd):
        report = weight_import.import_into(model, weight_import.state_arrays(payload))
        logger.info(f"imported {path}: {len(report.filled)} of {len(report.target_paths)} "
                    f"tensors filled, {len(report.unmatched)} reference keys unmatched")
    else:
        model.load_state_dict(sd)


def restore_for_inference(cfg, device: str = "cuda"):
    """(model in eval mode, checkpoint step) for serving or export: the model
    of `cfg` on `device` (the card unless the caller asks for the CPU), the
    newest checkpoint under OUTPUT_DIR restored, else MODEL.WEIGHTS.  A step
    of 0 and no MODEL.WEIGHTS is logged: nothing trained was loaded."""
    from dafne_torch.models import build_model
    from dafne_torch.parallel.distributed import local_device

    model = build_model(cfg, device=local_device(device),
                        generator=torch.Generator().manual_seed(max(cfg.SEED, 0)))
    step = Checkpointer(cfg.OUTPUT_DIR).resume_or_load(model, cfg, resume=True)
    if not step and not cfg.MODEL.WEIGHTS:
        logger.warning(f"no checkpoint under {cfg.OUTPUT_DIR} and MODEL.WEIGHTS is empty: "
                       "untrained weights")
    return model.eval(), int(step)
