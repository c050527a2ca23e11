"""Metric writers: terminal, JSONL and TensorBoard.

Counterpart of ``dafne_tpu/engine/events.py`` (``TerminalWriter``,
``JSONWriter``, ``TensorBoardWriter``, ``build_writers``).  The TensorBoard
writer imports ``tensorboard`` when it is built, and writes nothing when
the package is not installed, as JAX's writes nothing without TensorFlow.
``mark`` and ``elapsed_ms`` time a span on a device's stream.  With
several processes ``do_train`` builds the writers on process 0 only (JAX
``train_loop.py:378-381``); the metrics it writes are the global ones.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import time
from collections import deque
from typing import Dict

import torch

logger = logging.getLogger("dafne_torch")


def mark(device: torch.device):
    """A point in time on `device`'s stream (a CUDA event), or on the host
    clock off the card."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    """Milliseconds from ``mark`` `a` to ``mark`` `b` (CUDA events: once `b`
    has completed)."""
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


class EventWriter:
    def write(self, step: int, metrics: Dict[str, float]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class TerminalWriter(EventWriter):
    """CommonMetricPrinter-style line: metrics, it/s and ETA."""

    def __init__(self, max_iter: int, window: int = 20):
        self.max_iter = max_iter
        self.times = deque(maxlen=window)
        self.last = None
        self.last_step = None

    def write(self, step, metrics):
        now = time.perf_counter()
        if self.last is not None and step > self.last_step:
            # per-iteration time even when writes happen every N iterations
            self.times.append((now - self.last) / (step - self.last_step))
        self.last = now
        self.last_step = step
        eta = speed = ""
        if self.times:
            per_it = sum(self.times) / len(self.times)
            eta = f" eta: {datetime.timedelta(seconds=int((self.max_iter - step) * per_it))}"
            speed = f" {1.0 / per_it:.2f} it/s"
        parts = [f"{k}: {v:.4g}" for k, v in sorted(metrics.items()) if isinstance(v, (int, float))]
        logger.info(f"iter {step}/{self.max_iter}{eta}{speed}  " + "  ".join(parts))


class JSONWriter(EventWriter):
    """One JSON object per write, appended to `path` (metrics.json)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def write(self, step, metrics):
        rec = {"iteration": step}
        rec.update({k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))})
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


class TensorBoardWriter(EventWriter):
    """Each numeric metric as a scalar under its own tag (``simple_value``,
    as ``SummaryWriter.add_scalar`` writes it), one event per write, in an
    event file under `log_dir` (OUTPUT_DIR/tb); silent without the
    ``tensorboard`` package.

    The file is written with tensorboard's own event protos and record
    framing, not through ``torch.utils.tensorboard``, which imports
    TensorFlow wherever TensorFlow is installed."""

    def __init__(self, log_dir: str):
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.record_writer import RecordWriter
        except ImportError:
            self.f = None
            return
        self.Event, self.Summary = Event, Summary
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self.f = open(os.path.join(log_dir, name), "wb")
        self.records = RecordWriter(self.f)
        self._event(file_version="brain.Event:2")

    def _event(self, **fields) -> None:
        self.records.write(self.Event(wall_time=time.time(), **fields).SerializeToString())
        self.f.flush()

    def write(self, step, metrics):
        if self.f is None:
            return
        values = [self.Summary.Value(tag=k, simple_value=float(v))
                  for k, v in metrics.items() if isinstance(v, (int, float))]
        self._event(step=int(step), summary=self.Summary(value=values))

    def close(self):
        if self.f is not None:
            self.f.close()


def build_writers(output_dir: str, max_iter: int):
    return [TerminalWriter(max_iter), JSONWriter(os.path.join(output_dir, "metrics.json")),
            TensorBoardWriter(os.path.join(output_dir, "tb"))]
