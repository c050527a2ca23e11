"""The port's CLI in several CPU processes (``python -m dafne_torch.tools.train``).

The narrow R-50 of ``tests/test_torch_model.py`` on the synthetic 256^2
scenes (``synthetic_gen_{train,val}``, 4 of each, resized to 128^2).  One
process trains 3 steps and evaluates; two processes (a gloo group through
the environment contract, ``DAFNE_COORDINATOR`` a ``file://`` store in the
test's directory) evaluate its checkpoint with ``--eval-only`` and give
process 0 the same mAP, per-class APs and Task1 files, written once, and
after them the same TTA results as one process's ``--eval-only``; two
processes train the same 3 steps from scratch and write ``metrics.json``,
``config.yaml``, the evaluation files and the checkpoint once, each process
its own log; and the one process's step-3 checkpoint resumes under two
processes to step 5, with each metric row written once.  Every process has
its own timeout, so a process waiting on a missing peer fails the test.
"""

import json
import os
import shutil
import subprocess
import sys

from tests.test_torch_model import NARROW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
ARGS = [str(v) for v in NARROW] + [
    "MODEL.DAFNE.NUM_CLASSES", "6", "DATASETS.TRAIN", "('synthetic_gen_train',)",
    "DATASETS.TEST", "('synthetic_gen_val',)", "DEBUG.OVERFIT_NUM_IMAGES", "4",
    "INPUT.MIN_SIZE_TRAIN", "(128,)", "INPUT.MAX_SIZE_TRAIN", "128", "INPUT.MIN_SIZE_TEST", "128",
    "INPUT.MAX_SIZE_TEST", "128", "SOLVER.IMS_PER_BATCH", "4", "SOLVER.MAX_ITER", "3",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0", "TPU.EVAL_BATCH", "4",
    "TPU.NMS_GROUP_CANDIDATES", "32", "TPU.NMS_MAX_CANDIDATES", "128",
    "MODEL.DAFNE.PRE_NMS_TOPK_TEST", "200", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "100",
    "MODEL.DAFNE.INFERENCE_TH_TEST", "0.0", "DATALOADER.NUM_WORKERS", "0",
    "TPU.TRAIN_DEVICE_AUG", "False", "TPU.MAX_INSTANCES", "16", "SEED", "4",
]

# test-time augmentation of the eval-only runs: 3 copies per image at 128^2
TTA = ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(128,)", "TEST.AUG.MAX_SIZE", "128"]


def launch(out_dir, world, flags=(), opts=(), store=None):
    """`world` processes of the CLI on the CPU (one without a group when
    `world` is 0) with `flags` and the overrides `opts` after ``ARGS``;
    returns their outputs.  Fails on any nonzero exit."""
    cmd = [sys.executable, "-m", "dafne_torch.tools.train", "--cpu", *flags, *ARGS, *opts,
           "OUTPUT_DIR", str(out_dir)]
    base = {k: v for k, v in os.environ.items() if not k.startswith("DAFNE_")}
    base.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    envs = [base] if world == 0 else [
        {**base, "DAFNE_COORDINATOR": f"file://{store}", "DAFNE_NUM_PROCESSES": str(world),
         "DAFNE_PROCESS_ID": str(r)} for r in range(world)]
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for env in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(o[-3000:] for o in outs)
    return outs


def summary(out):
    """The CLI's last log line: the process's run summary."""
    line = [ln for ln in out.splitlines() if "run summary " in ln][-1]
    return json.loads(line.split("run summary ", 1)[1])


def results(out_dir, kind="inference"):
    path = os.path.join(out_dir, kind, "synthetic_gen_val", "results.txt")
    with open(path) as f:
        return dict((k, float(v)) for k, v in (ln.split(": ") for ln in f.read().splitlines()))


def task1(out_dir, kind="inference"):
    d = os.path.join(out_dir, kind, "synthetic_gen_val", "task1")
    return {f: open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))}


def metric_rows(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(ln)["iteration"] for ln in f]


def test_cli_two_processes_train_eval_and_resume(tmp_path):
    one, two, ev, el = (tmp_path / d for d in ("one", "two", "eval", "elastic"))
    (out1,) = launch(one, 0)
    s1 = summary(out1)
    assert s1["world"] == 1 and len(s1["loss"]) == 3
    want = results(one)
    assert metric_rows(one) == [1]

    # two processes evaluate the one process's checkpoint, then run TTA;
    # one process does the same
    ev1 = tmp_path / "eval1"
    for d in (ev, ev1):
        shutil.copytree(one / "checkpoints", d / "checkpoints")
    (out,) = launch(ev1, 0, ["--eval-only"], TTA)
    outs = launch(ev, 2, ["--eval-only"], TTA, store=tmp_path / "store_eval")
    assert [summary(o)["rank"] for o in outs] == [0, 1]
    got = results(ev)
    assert got == want  # the mAP of a 3-step model: 0 here, so the detections are compared too
    assert task1(ev) == task1(one) and any(task1(one).values())
    assert results(ev, "inference_tta") == results(ev1, "inference_tta")
    assert task1(ev, "inference_tta") == task1(ev1, "inference_tta")
    assert any(task1(ev1, "inference_tta").values())
    assert sorted(os.listdir(ev)) == ["checkpoints", "config.yaml", "inference", "inference_tta",
                                      "log.txt", "log.txt.rank1", "run_report.json",
                                      "test_results.csv"]
    with open(ev / "test_results.csv") as f:
        rows = f.read().splitlines()
    assert len(rows) == 1 + len(want)  # the header and one row per metric: written once

    # two processes train the same 3 steps at the same global batch
    outs = launch(two, 2, store=tmp_path / "store_two")
    s2 = [summary(o) for o in outs]
    assert [s["world"] for s in s2] == [2, 2] and s2[0]["loss"] == s2[1]["loss"]
    for a, b in zip(s2[0]["loss"], s1["loss"]):
        assert abs(a - b) <= 1e-4 * abs(b), (s2[0]["loss"], s1["loss"])
    assert metric_rows(two) == [1]
    assert os.listdir(two / "checkpoints") == os.listdir(one / "checkpoints")
    assert not [f for f in os.listdir(two) if f.startswith("error")]
    assert set(results(two)) == set(want)

    # elastic: the one process's step-3 checkpoint resumes under two to step 5
    shutil.copytree(one, el)
    outs = launch(el, 2, ["--resume"], ["SOLVER.MAX_ITER", "5"], store=tmp_path / "store_el")
    assert [len(summary(o)["loss"]) for o in outs] == [2, 2]
    rows = metric_rows(el)
    assert rows == [1, 4] and len(set(rows)) == len(rows)
    assert "model_0000005.pth" in os.listdir(el / "checkpoints")


def test_cli_failure_writes_one_error_file_per_process(tmp_path):
    """A failure after the group forms: each process writes its own
    traceback (error_rank<r>.txt), exits nonzero and leaves the group."""
    cmd = [sys.executable, "-m", "dafne_torch.tools.train", "--cpu", *ARGS,
           "DATASETS.TRAIN", "('no_such_dataset',)", "OUTPUT_DIR", str(tmp_path / "out")]
    base = {k: v for k, v in os.environ.items() if not k.startswith("DAFNE_")}
    base.update(PYTHONPATH=ROOT, DAFNE_COORDINATOR=f"file://{tmp_path / 'store'}",
                DAFNE_NUM_PROCESSES="2")
    procs = [subprocess.Popen(cmd, env={**base, "DAFNE_PROCESS_ID": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode != 0 for p in procs), outs
    errors = sorted(f for f in os.listdir(tmp_path / "out") if f.startswith("error"))
    assert errors == ["error_rank0.txt", "error_rank1.txt"]
    for f in errors:
        assert "no_such_dataset" in open(tmp_path / "out" / f).read()
