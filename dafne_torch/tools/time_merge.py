"""Time the DOTA cross-tile merge: the classes one after another against
the classes on threads.

    python3 dafne_torch/tools/time_merge.py [--task1 DIR] [--threads 8] [--rounds 3]

DIR holds Task1_<class>.txt files of tile detections; it defaults to the
test split's that chip_smoke.py's phase 15 leaves under
output/chip_smoke_files.  Each round merges every file of DIR with
``result_merge._merge_one_file`` in the order serial, threads, threads,
serial, into a directory of its own under the gitignored ``output/``; every
run's merged files must be byte-equal to the first run's.  Host clock.
Prints one JSON line: the seconds of each run, the host's CPU count, the
lines in and out, and the card's name and power limit when nvidia-smi is
there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TASK1 = os.path.join(ROOT, "output", "chip_smoke_files", "test", "inference", "dota_1_test_1024",
                     "task1")


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task1", default=TASK1)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from dafne_torch.evaluation.result_merge import _merge_one_file

    files = sorted(fn for fn in os.listdir(args.task1)
                   if fn.startswith("Task1_") and fn.endswith(".txt"))
    out_root = os.path.join(ROOT, "output", "time_merge")
    seconds = {"serial": [], "threads": []}
    first = None
    for r in range(args.rounds):
        for i, way in enumerate(("serial", "threads", "threads", "serial")):
            dst = os.path.join(out_root, f"{r}_{i}_{way}")
            shutil.rmtree(dst, ignore_errors=True)
            os.makedirs(dst)
            jobs = [(os.path.join(args.task1, fn), os.path.join(dst, fn), 0.1) for fn in files]
            t0 = time.perf_counter()
            if way == "serial":
                for job in jobs:
                    _merge_one_file(job)
            else:
                with ThreadPoolExecutor(min(args.threads, len(jobs))) as ex:
                    list(ex.map(_merge_one_file, jobs))
            seconds[way].append(time.perf_counter() - t0)
            merged = {fn: open(os.path.join(dst, fn), "rb").read() for fn in files}
            if first is None:
                first = merged
            elif merged != first:
                raise SystemExit(f"{way} run {r}_{i}: merged files differ from the first run's")
    shutil.rmtree(out_root, ignore_errors=True)

    def count(path):
        with open(path) as f:
            return sum(1 for line in f if line.strip())

    print(json.dumps({
        "files": len(files),
        "lines_in": sum(count(os.path.join(args.task1, fn)) for fn in files),
        "lines_out": sum(v.count(b"\n") for v in first.values()),
        "threads": args.threads, "cpu_count": os.cpu_count(),
        "cpus_usable": len(os.sched_getaffinity(0)),
        "serial_s": seconds["serial"], "threads_s": seconds["threads"],
        "card": _card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
