"""Time the 2-D tiled suppression kernel (K2) and the assignment kernel (K3)
on one GPU.

    python3 dafne_torch/tools/time_kernels.py [--root DIR] [--reps 50]

K2 runs on two inputs: the dense score-ordered mix of chip_smoke.py phase 10
(B = 8, N = 4096, 15 classes interleaved, every slot valid) and the grouped
NMS input of one eval batch ([B * G, K] = [112, 512], from the DOTA-1.0 1024
inference model at full width with seeded random weights and the class
bias at -2 on 8 synthetic 1024^2 scenes, as dafne_torch/tools/time_decode.py
builds it).  K3 runs on the three mixes of chip_smoke.py phase 6 (B = 8,
K = 21 824 locations of a 1024^2 canvas, M = 256 slots): the packed gts of
synthetic train scenes, 256 valid random gts, and 128 gts duplicated.
For each: CUDA events around each call of the wrapper (median, 10th and
90th percentile of --reps calls; the wrapper's host time is inside when
the card waits for the launch), the kernel's own device time and the
device time of every kernel of the call (a fill, say) from a
torch.profiler trace, and whether the result equals the plain version
(K2: the bit rows equal the packed plain S, or int8 S equal to it; K3:
min_area bit-equal and argmin equal).  K2 lines also give K1's device time
on the same input; K3 lines the (location, valid gt) pairs, the pairs the
kernel runs its pair body on (its per-block gt lists; every valid pair for
a kernel without them) and the candidate pairs (those that pass center
sampling and the level filter: assign.pair_counts).

--root imports dafne_torch from another checkout, such as a parent commit
unpacked with ``git archive``, so that two versions compare in one call on
one card; the inputs are built by this checkout's chip_smoke.py helpers
either way, and the device times come from the checkout's
``utils/measure.py::device_ms`` (so --root needs that module).  Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BATCH, CANVAS, GROUP_K, M_GT = 8, 1024, 512, 256


def _chip_smoke():
    """This checkout's chip_smoke.py, for its input mixes."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def event_stats(fn, reps):
    """{median, p10, p90} of per-call CUDA-event times of fn(), ms, after 3
    warm-up calls."""
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
    times.sort()
    return {"median_ms": statistics.median(times), "p10_ms": times[reps // 10],
            "p90_ms": times[(9 * reps) // 10]}


def grouped_input(cfg_mod):
    """The grouped NMS kernels' input of one eval batch: (corners [B * G, K,
    8], classes [B * G, K]) on the card, and the NMS threshold."""
    import torch

    from dafne_torch.data.synthetic import load_synthetic_gen
    from dafne_torch.engine.predictor import Predictor
    from dafne_torch.models import build_model
    from dafne_torch.ops.nms import grouped_nms_inputs, single_group_inputs
    from dafne_torch.ops.postprocess import DecodeSpec, nms_candidates

    cfg = cfg_mod.get_cfg()
    cfg.INPUT.MAX_SIZE_TEST = CANVAS
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    scenes = [r["image"] for r in load_synthetic_gen("val", BATCH, hw=CANVAS, max_boxes=96)]
    images = Predictor(model, cfg, batch=BATCH).canvas(scenes)
    spec = dataclasses.replace(DecodeSpec.from_config(cfg), nms_group_candidates=GROUP_K)
    with torch.inference_mode():
        c = nms_candidates(model(images), spec)
        pc, pk, _ = single_group_inputs(*grouped_nms_inputs(
            c["corners"], c["scores"], c["classes"], c["valid"], spec.class_merge,
            spec.num_classes, GROUP_K, max(spec.nms_max_candidates, spec.post_nms_topk))[1:])
    return pc.clone(), pk.clone(), spec.nms_threshold


def time_k2(smoke, inputs, reps):
    import torch

    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.utils.measure import device_ms

    if hasattr(K, "suppression_bits_2d_cuda"):  # bit rows out
        k2, name, as_bits = K.suppression_bits_2d_cuda, "suppression_bits_2d_kernel", True
    else:  # the int8 S of the first design
        k2, name, as_bits = K.suppression_matrix_2d_cuda, "suppression_2d_kernel", False
    out = {}
    for mix, (corners, classes, thr) in inputs.items():
        fn = lambda: k2(corners, classes, thr)  # noqa: E731
        plain = K.suppression_matrix_plain(corners, classes, thr)
        want = K.pack_suppression_bits(plain) if as_bits else plain
        equal = bool(torch.equal(fn(), want))
        del plain, want
        torch.cuda.empty_cache()
        out[mix] = {"shape": list(classes.shape), "equal_to_plain": equal,
                    **event_stats(fn, reps),
                    "device_ms": device_ms(fn, name),
                    "device_busy_ms": device_ms(fn, "", launches=None),
                    "k1_device_ms": device_ms(
                        lambda: K.suppression_bits_cuda(corners, classes, thr),
                        "suppression_bits_kernel")}
    return out


def time_k3(smoke, reps):
    import numpy as np
    import torch

    from dafne_torch.config import get_cfg
    from dafne_torch.data.mapper import DatasetMapper
    from dafne_torch.data.synthetic import load_synthetic_gen
    from dafne_torch.engine.trainer import make_location_tables
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.targets import AssignmentSpec
    from dafne_torch.utils.measure import device_ms

    cfg = get_cfg()
    cfg.merge_from_list(smoke.DOTA_1024)
    spec = AssignmentSpec.from_config(cfg)
    _, loc, st, rg = make_location_tables((CANVAS, CANVAS), spec, device="cuda")
    records = load_synthetic_gen("train", BATCH, hw=CANVAS, max_boxes=96)
    mapper = DatasetMapper(cfg, (CANVAS, CANVAS))
    mixes = {"train-scenes": smoke.gt_tensors(
        [mapper(r, np.random.RandomState(i)) for i, r in enumerate(records)], "cuda")}
    mixes["all-256-valid"] = smoke.full_gts(np.random.RandomState(0), BATCH, M_GT)
    mixes["duplicated"] = {k: torch.cat([v[:, : M_GT // 2]] * 2, 1).contiguous()
                           for k, v in mixes["all-256-valid"].items()}
    out = {}
    for mix, g in mixes.items():
        args = (loc, st, rg, g["gt_corners"], g["gt_hbox"], g["gt_area"], g["gt_valid"], spec)
        fn = lambda: A.assign_argmin_cuda(*args)  # noqa: E731
        km, ka = fn()
        pm, pa = A.assign_argmin_plain(*args)
        if hasattr(A, "pair_counts"):
            pairs = A.pair_counts(loc, st, rg, g["gt_hbox"], g["gt_valid"], spec)
        else:  # a kernel without per-block lists runs every valid pair
            valid = loc.shape[0] * int(g["gt_valid"].sum())
            pairs = {"valid": valid, "listed": valid}
        out[mix] = {"equal_to_plain": bool(torch.equal(km, pm) and torch.equal(ka, pa)),
                    "positives": int((km < A.INF).sum()), "pairs": pairs,
                    **event_stats(fn, reps),
                    "device_ms": device_ms(fn, "assign_argmin_kernel"),
                    "device_busy_ms": device_ms(fn, "", launches=None)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose dafne_torch is timed")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per input")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    from dafne_torch import config as cfg_mod

    smoke = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.benchmark = True
    dense = smoke.class_major_mix(np.random.RandomState(0), BATCH, 4096, 4096, class_major=False)
    inputs = {"dense-15cls-score-order": (*dense, 0.1), "grouped-eval": grouped_input(cfg_mod)}
    out = {"root": os.path.abspath(args.root), "card": card, "reps": args.reps,
           "k2": time_k2(smoke, inputs, args.reps), "k3": time_k3(smoke, args.reps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
