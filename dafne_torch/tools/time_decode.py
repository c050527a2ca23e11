"""Time the inference decode (head outputs to detections) on one GPU.

    python3 dafne_torch/tools/time_decode.py [--root DIR] [--reps 50]

Builds the DOTA-1.0 1024 inference model at full width (R-50, FPN P3-P7,
15 classes, bf16, seeded random weights with the class bias at -2, as
chip_smoke.py's main path), runs one batch of 8 synthetic 1024^2 scenes
through it and times ``decode_detections`` on that head three ways: the
global cap (TPU.NMS_MAX_CANDIDATES 4096), per-class-group NMS
(TPU.NMS_GROUP_CANDIDATES 512) and no cap (TPU.NMS_MAX_CANDIDATES 0).  For
each: CUDA events around each call (median, 10th and 90th percentile of
--reps calls), the card's busy time (the sum of the call's kernels in a
torch.profiler trace, averaged over 20 calls), the kernels it launches
per call and the device time of each suppression and greedy kernel in it.
Events minus busy time is what the card waits on the host.  A way that a
version refuses (an N beyond its kernel's limit) records the error.

--root imports dafne_torch from another checkout, such as a parent commit
unpacked with ``git archive``, so that two versions compare in one call on
one card; it uses only entry points that the port has had since its
evaluation slice.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys

BATCH, CANVAS, GROUP_K = 8, 1024, 512


def event_times(fn, reps):
    """Per-call CUDA-event times of fn(), ms, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_busy(fn, reps=20):
    """(busy ms, kernels, {NMS kernel: ms}) per call of fn(): the device
    time and the count of its kernels (memory copies and fills included)
    in a profiler trace, and the time of each suppression or greedy kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    nms = {}
    for e in events:
        m = re.search(r"\w*(?:greedy|suppression)\w*", e.key)
        if m:
            nms[m.group(0)] = nms.get(m.group(0), 0.0) + e.self_device_time_total / reps / 1e3
    return busy_us / reps / 1e3, sum(e.count for e in events) / reps, nms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose dafne_torch is timed")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per decode")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_decode: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    from dafne_torch.config import get_cfg
    from dafne_torch.data.synthetic import load_synthetic_gen
    from dafne_torch.engine.predictor import Predictor
    from dafne_torch.models import build_model
    from dafne_torch.ops.postprocess import DecodeSpec, decode_detections

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.benchmark = True
    cfg = get_cfg()
    cfg.INPUT.MAX_SIZE_TEST = CANVAS
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    scenes = [r["image"] for r in load_synthetic_gen("val", BATCH, hw=CANVAS, max_boxes=96)]
    images = Predictor(model, cfg, batch=BATCH).canvas(scenes)
    spec = DecodeSpec.from_config(cfg)
    specs = {"global-cap": spec,
             "grouped": dataclasses.replace(spec, nms_group_candidates=GROUP_K),
             "no-cap": dataclasses.replace(spec, nms_max_candidates=0)}
    out = {"root": os.path.abspath(args.root), "card": card, "reps": args.reps}
    with torch.inference_mode():
        head = model(images)
        for name, s in specs.items():
            fn = lambda: decode_detections(head, s)  # noqa: E731
            try:
                fn()
            except (ValueError, RuntimeError) as e:
                out[name] = {"error": str(e)}
                continue
            times = sorted(event_times(fn, args.reps))
            busy, kernels, nms = device_busy(fn)
            out[name] = {"median_ms": statistics.median(times),
                         "p10_ms": times[len(times) // 10],
                         "p90_ms": times[(9 * len(times)) // 10],
                         "device_busy_ms": busy, "kernels_per_call": kernels,
                         "nms_kernels_ms": nms,
                         "kept_per_img": float(fn()["valid"].sum(1).float().mean())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
