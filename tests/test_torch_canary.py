"""The canary tool (``dafne_torch/tools/canary.py``) on the CPU.

``loss_summary`` reads the first and last 20 steps and the largest loss
after the warm-up; two runs of the narrow synthetic recipe, two steps
each, one per process with a SEED each, come back as one JSON line with
a summary per run in seed order.
"""

import json
import os

import pytest

from dafne_torch.tools import canary

from test_torch_model import NARROW


def test_loss_summary_reads_the_ends_and_the_largest_loss_after_the_warmup():
    losses = [3.0] * 20 + [9.0, 1.0] + [0.5] * 58 + [2.0] + [0.25] * 19
    s = canary.loss_summary(losses, warmup=22)
    assert s["first20"] == 3.0
    assert s["last20"] == pytest.approx((2.0 + 0.25 * 19) / 20)
    assert (s["max_after_warmup"], s["max_step"]) == (2.0, 81)
    short = canary.loss_summary([1.0, 4.0, 2.0], warmup=100)  # all within the warm-up
    assert (short["max_after_warmup"], short["max_step"]) == (4.0, 2)


def test_two_seeded_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    opts = [str(x) for x in NARROW] + ["SOLVER.MAX_ITER", "2", "DATALOADER.NUM_WORKERS", "1",
                                       "SOLVER.CHECKPOINT_PERIOD", "0"]
    assert canary.main(["--cpu", "--seeds", "3,5", "--out", str(tmp_path)] + opts) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["seed"] for r in out["runs"]] == [3, 5]
    for i, r in enumerate(out["runs"]):
        assert r["steps"] == 2 and not r["deterministic"] and not r["cudnn_benchmark"]
        assert 0.0 <= r["mAP"] <= 100.0
        assert os.path.exists(tmp_path / f"run{i}" / "canary.log")
    assert out["maps"] == [r["mAP"] for r in out["runs"]]
    assert out["gate"] == canary.MAP_GATE == 50.0
