"""The train loop's run-time services on the CPU: the run report and its
hooks, the ``DEBUG.PROFILE_ITERS`` trace window, asynchronous checkpoints
and the TensorBoard writer.

The report equals ``dafne_tpu.utils.notify.build_report`` for the same
inputs; the CLI writes ``run_report.json`` (``eval_done``, or ``failed``
beside ``error.txt``) and pipes it to DAFNE_NOTIFY_CMD.  On 3-step
``do_train`` runs of the narrow R-50 at 128^2: a window writes a Chrome
trace, one past SOLVER.MAX_ITER is closed at the loop's end, a malformed
one raises JAX's ValueError and a resume past its start traces nothing.
Asynchronous saves write the state dicts a synchronous save writes, a
resume from them takes the same next step bit for bit, and a worker's
failure is raised by the next call.  The TensorBoard event file holds the
tags, steps and values JAX's ``TensorBoardWriter`` writes (both read with
tensorboard's ``EventAccumulator``), and with ``tensorboard`` blocked the
writer writes nothing and raises nothing.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dafne_tpu.config import get_cfg as jax_get_cfg
from dafne_tpu.utils.notify import build_report as jax_build_report

from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog
from dafne_torch.data.synthetic import GEN_CLASSES, load_synthetic_gen
from dafne_torch.engine import checkpoint as C
from dafne_torch.engine.events import TensorBoardWriter
from dafne_torch.engine.optimizer import build_optimizer
from dafne_torch.engine.train_loop import do_train
from dafne_torch.models import build_model
from dafne_torch.tools.train import main as cli_main
from dafne_torch.utils.notify import build_report, notify

from test_torch_model import NARROW, narrow_cfgs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = [str(v) for v in NARROW] + [
    "INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128", "SOLVER.IMS_PER_BATCH", "2",
    "SOLVER.MAX_ITER", "3", "SOLVER.WARMUP_ITERS", "0", "DATALOADER.NUM_WORKERS", "0",
    "MODEL.DAFNE.NUM_CLASSES", "6"]


@pytest.fixture(scope="module")
def records():
    return load_synthetic_gen("train", 4, hw=128, max_boxes=6)


def _cfg(out_dir, extra=()):
    _, cfg = narrow_cfgs(TRAIN + ["OUTPUT_DIR", str(out_dir)] + list(extra))
    return cfg


def _train(cfg, records, resume=False, seed=1):
    """do_train from seeded weights; returns (stats, the model)."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    stats = {}
    do_train(cfg, model, records, resume=resume, stats=stats)
    return stats, model


# ---- the run report ----------------------------------------------------------

@pytest.mark.parametrize("status,results,error", [
    ("train_done", {"synthetic_val": {"mAP": 41.5, "AP50/a": 30.0}}, ""),
    ("eval_done", {}, ""), ("failed", None, "Traceback: boom")])
def test_report_equals_jax(tmp_path, status, results, error):
    jcfg, cfg = narrow_cfgs(["OUTPUT_DIR", str(tmp_path), "EXPERIMENT_NAME", "exp7"])
    assert get_default_experiment() == jax_get_cfg().EXPERIMENT_NAME == "dafne"
    assert build_report(status, cfg, results, error) == jax_build_report(status, jcfg, results, error)
    assert build_report(status) == jax_build_report(status)


def get_default_experiment():
    from dafne_torch.config import get_cfg

    return get_cfg().EXPERIMENT_NAME


def test_notify_writes_report_and_pipes_it_to_the_hook(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path / "run")
    hook = tmp_path / "hook.json"
    monkeypatch.setenv("DAFNE_NOTIFY_CMD", f"cat > {hook}")
    monkeypatch.delenv("EMAIL_CREDENTIALS", raising=False)
    report = notify("train_done", cfg, {"synthetic_val": {"mAP": np.float32(12.5)}})
    assert report["experiment"] == "dafne" and report["output_dir"] == str(tmp_path / "run")
    written = json.loads((tmp_path / "run" / "run_report.json").read_text())
    assert written == json.loads(hook.read_text()) == json.loads(json.dumps(report, default=float))
    assert written["results"]["synthetic_val"]["mAP"] == 12.5


def test_cli_reports_eval_done_and_failed(tmp_path, monkeypatch, records):
    hook = tmp_path / "hook.json"
    monkeypatch.setenv("DAFNE_NOTIFY_CMD", f"cat > {hook}")
    name = "torch_runtime_gen128"
    DatasetCatalog.register(name, lambda: records[:2])
    MetadataCatalog[name] = {"evaluator_type": "synthetic", "thing_classes": GEN_CLASSES,
                             "is_test": False}
    out = tmp_path / "eval"
    args = TRAIN + ["OUTPUT_DIR", str(out), "DATASETS.TEST", f"('{name}',)",
                    "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "128",
                    "TPU.EVAL_BATCH", "2", "TPU.NMS_GROUP_CANDIDATES", "32",
                    "TPU.NMS_MAX_CANDIDATES", "128", "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "100",
                    "MODEL.DAFNE.POST_NMS_TOPK_TEST", "50"]
    results = cli_main(["--eval-only"] + args, device="cpu")
    report = json.loads((out / "run_report.json").read_text())
    assert report == json.loads(hook.read_text())
    assert report["status"] == "eval_done" and report["results"] == results

    bad = tmp_path / "bad"
    with pytest.raises(KeyError):
        cli_main(["--eval-only", "OUTPUT_DIR", str(bad), "DATASETS.TEST", "('no_such_set',)"]
                 + [str(v) for v in NARROW], device="cpu")
    report = json.loads((bad / "run_report.json").read_text())
    assert report == json.loads(hook.read_text())
    assert report["status"] == "failed" and "no_such_set" in report["error"]
    assert "no_such_set" in (bad / "error.txt").read_text()


# ---- the profiler window -----------------------------------------------------

def _trace_files(out_dir):
    d = os.path.join(out_dir, "profile")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


@pytest.mark.parametrize("window,trace", [((1, 2), "trace_1-2.json"), ((2, 10), "trace_2-3.json")])
def test_profile_window_writes_a_trace(tmp_path, records, window, trace):
    cfg = _cfg(tmp_path, ["DEBUG.PROFILE_ITERS", str(list(window))])
    _train(cfg, records)
    assert _trace_files(tmp_path) == [trace]
    with open(tmp_path / "profile" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


def test_profile_window_malformed_raises(tmp_path, records):
    cfg = _cfg(tmp_path, ["DEBUG.PROFILE_ITERS", "[1]"])
    with pytest.raises(ValueError, match=r"DEBUG.PROFILE_ITERS must be \[start, stop\], got \[1\]"):
        _train(cfg, records)


def test_profile_resume_past_start_traces_nothing(tmp_path, records):
    _train(_cfg(tmp_path, ["SOLVER.MAX_ITER", "2"]), records)
    stats, _ = _train(_cfg(tmp_path, ["DEBUG.PROFILE_ITERS", "[1, 3]"]), records, resume=True)
    assert [len(v["ms"]) for v in stats["steps"].values()] == [1]  # step 3 alone
    assert _trace_files(tmp_path) == []


# ---- asynchronous checkpoints ------------------------------------------------

def _tensors_equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_saves_equal_sync_saves_and_resume_exactly(tmp_path, records, monkeypatch):
    """Two equal 2-step runs, one saving asynchronously (do_train's way) and
    one synchronously: the same files; then each resumes to step 3 with the
    same loss and parameters bit for bit."""
    extra = ["SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "1"]
    a_stats, _ = _train(_cfg(tmp_path / "async", extra), records)
    assert len(a_stats["checkpoints"]["blocking_ms"]) == len(a_stats["checkpoints"]["worker_ms"]) == 3
    with monkeypatch.context() as m:
        m.setattr(C.Checkpointer, "save_async", C.Checkpointer.save)
        _train(_cfg(tmp_path / "sync", extra), records)
    for step in (1, 2):
        name = f"model_{step:07d}.pth"
        a = torch.load(tmp_path / "async" / "checkpoints" / name, weights_only=True)
        s = torch.load(tmp_path / "sync" / "checkpoints" / name, weights_only=True)
        assert _tensors_equal(a, s) and a["step"] == step and "optimizer" in a and "scheduler" in a
    resumed = {}
    for run in ("async", "sync"):
        stats, model = _train(_cfg(tmp_path / run), records, resume=True, seed=9)
        resumed[run] = ([v["loss"] for v in stats["steps"].values()], model.state_dict())
    assert resumed["async"][0] == resumed["sync"][0] and len(resumed["async"][0][0]) == 1
    assert _tensors_equal(resumed["async"][1], resumed["sync"][1])


def test_failing_worker_raises_on_the_next_call(tmp_path):
    _, cfg = narrow_cfgs(["OUTPUT_DIR", str(tmp_path)])
    model = build_model(cfg, device="cpu")
    optimizer, scheduler = build_optimizer(cfg, model)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    for next_call in ("wait", "save_async"):
        ck = C.Checkpointer(str(tmp_path))
        ck.dir = str(blocker)  # a file where the directory should be: every write fails
        ck.save_async(1, model, optimizer, scheduler)
        if next_call == "wait":
            with pytest.raises(RuntimeError, match="asynchronous checkpoint") as e:
                ck.wait()
        else:
            deadline = time.monotonic() + 60
            while not ck.worker_s and time.monotonic() < deadline:  # until the worker fails
                time.sleep(0.01)
            with pytest.raises(RuntimeError, match="asynchronous checkpoint") as e:
                ck.save_async(2, model, optimizer, scheduler)
            ck.wait()
        assert "not_a_dir" in str(e.value.__cause__)
    assert C.Checkpointer(str(tmp_path)).latest_step() is None


# ---- TensorBoard -------------------------------------------------------------

def _event_values(log_dir, jax_side):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    if jax_side:  # tf.summary.scalar writes a tensor summary
        return {tag: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                      for e in acc.Tensors(tag)] for tag in acc.Tags()["tensors"]}
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_events_equal_jax(tmp_path):
    from dafne_tpu.engine.events import TensorBoardWriter as JaxTensorBoardWriter

    writes = [(1, {"loss/total": 3.14159274, "lr": 0.01, "num_pos": 12, "note": "text"}),
              (21, {"loss/total": 1.2345678, "lr": 0.009, "data_time": 0.25})]
    for cls, d in ((TensorBoardWriter, tmp_path / "port"), (JaxTensorBoardWriter, tmp_path / "jax")):
        w = cls(str(d))
        for step, metrics in writes:
            w.write(step, metrics)
        w.close()
    got, want = _event_values(tmp_path / "port", False), _event_values(tmp_path / "jax", True)
    assert got == want and set(got) == {"loss/total", "lr", "num_pos", "data_time"}


def test_tensorboard_writer_silent_without_tensorboard(tmp_path):
    code = ("import sys\nsys.modules['tensorboard'] = None\n"
            "from dafne_torch.engine.events import TensorBoardWriter, build_writers\n"
            f"d = {str(tmp_path / 'tb')!r}\n"
            "w = TensorBoardWriter(d)\nw.write(1, {'loss/total': 1.0})\nw.close()\n"
            "import os\nassert not os.path.exists(d)\n"
            f"assert len(build_writers({str(tmp_path)!r}, 3)) == 3\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
