#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's failure is caught):
  1. the card, and an nvcc build of dafne_torch/csrc/*.cu for sm_90a (and a
     g++ build of the host library csrc/png_unfilter.cpp);
  2. the suppression-matrix kernel (K1, S as bit rows) against its plain
     PyTorch version, packed, at N = 4096, batch 8, on a dense all-valid
     15-class mix and a 25%-valid class-major mix: bit rows equal word for
     word, with the live blocks it computes;
  3. the greedy keep kernel (over bit rows) against the plain sequential
     walk on those S and on one with a 300-box suppression chain (built
     int8, then packed): equal keep-sets;
  4. the main path: R-50 + FPN P3-P7 + DAFNe head at full width, 15 classes,
     a 1024x1024 canvas, bf16, batch 8, seeded random weights (cls bias -2 so
     that the 4096-slot NMS input is filled), after one warm-up batch
     WINDOWS windows of WINDOW_BATCHES batches of synthetic-scene requests
     through engine/predictor.py; both kernels must have launched in them;
     then one batch's wall time split on the host clock (canvas, copy to
     the card, eval step, the rest) and the device phases on CUDA events;
     and that batch's decode with no candidate cap (TPU.NMS_MAX_CANDIDATES
     0: every per-level survivor, ~9 000 per image, into NMS), with K1's
     bits and greedy's keep-set checked there too;
  5. the kernels against their plain versions on the main path's own NMS
     inputs (K1's bits word for word, greedy's keep-set against the plain
     walk), with times and bounds; and a small float32 reference check:
     the same narrow model on the card and on the CPU (plain versions) must
     give the same detections;
  6. the assignment kernel (K3) against its plain version at B = 8,
     K = 21 824 locations (a 1024^2 canvas), M = 256 gt slots, on the packed
     gts of synthetic train scenes, on 256 valid slots and on duplicated
     gts (ties): min_area bit-equal and argmin equal; with its device time,
     the pairs it runs its pair body on (its per-block gt lists) against
     the valid pairs, and its bound over the candidate pairs beside the
     earlier one over every valid pair;
  7. the training path: engine/train_loop.py::do_train at full width (the
     DOTA-1.0 1024 recipe, batch 8, bf16 compute with f32 params, flips and
     90-degree rotations), 3 warm-up steps, then TRAIN_STEPS timed steps in
     which K3 must launch once per step and every loss must be finite; a
     split of one step on CUDA events and peak memory;
  8. 30 steps on one fixed batch (warm-up off, BASE_LR 0.001): the mean
     of the last 5 total losses must be below that of the first 5;
  9. the narrow float32 model, batch 2 at 256^2, one train step on the card
     (kernel) and on the CPU (plain): labels equal on >= 99.9% of the
     locations, every loss within 1e-4 relative, params within atol 1e-5;
 10. the 2-D tiled suppression kernel (K2, S as bit rows) against its
     plain version, packed, and against K1 (which computes the same S for
     any order) at B = 8, N = 4096: a dense 15-class mix in score order and
     phase 2's 25%-valid class-major mix: bit rows equal word for word, with
     its live tiles, device time and bound;
 11. the eval path at full width: a checkpoint of the DOTA-1.0 1024 model
     (seeded random weights, cls bias -2), then the CLI's --eval-only in
     this process on N_EVAL_SCENES synthetic 1024^2 scenes with per-class-
     group NMS (K = 512), eval batch 8: results.txt, the Task1 files and
     test_results.csv written, K1 and greedy launched once per batch; eval
     img/s and the evaluator's time; one batch's decode through the grouped
     and the global-cap path with K1 and greedy inside each; the candidate
     mix; K1's bits equal to the packed plain S and the greedy kernel equal
     to the plain walk on every batch's [B * G, K] S; then a replay of
     every batch's grouped NMS with
     impl="pallas-2d" (K2's bit rows straight into the greedy kernel) equal
     to impl="pallas", running no kernel that impl="pallas" does not but
     K2 (no int8 S, fill or pack), and K2 against its plain version and K1
     on the grouped path's own [B * G, K] inputs.  No config
     key reaches `impl`, so the CLI never launches K2: its launches in the
     kernels line are the replay's;
 12. the narrow float32 model through do_test on 8 synthetic 256^2 scenes
     with grouped NMS, on the card (kernels) and on the CPU (plain): >= 99%
     of the CPU detections matched, mAP within 0.1; the evaluator fed the
     ground truth as detections gives mAP 100, and fed jittered ground truth
     plus false positives with mixed scores an mAP strictly between 0 and
     100.

 13. TTA at full width: the CLI's --eval-only with TEST.AUG.ENABLED on
     N_TTA_SCENES synthetic 1024^2 scenes from phase 11's checkpoint, the
     DOTA-1.0 1024 recipe's ladder (MIN_SIZES 256-1536, MAX_SIZE 1536, HFLIP
     and VFLIP: 15 copies per scene on canvases 256 to 1536, batch 8 down
     to 1), grouped NMS: K1 and greedy launched once per eval step, the
     inference_tta files written; per scene the warp and the eval steps per
     canvas (CUDA events), the fetch and the merge (host clock) and the
     boxes into and out of the merge; the peak memory; then one batch per
     canvas of the first scene rendered again: within WARP_TOL of the same
     gathers on the CPU, the unit-scale identity, hflip and vflip copies bit
     for bit, K1's bits and greedy's keep-set equal to their plain versions
     on that batch's NMS input; and the narrow float32 model's
     tta_inference_single on the card against the CPU (>= 99% of the CPU
     detections matched);
 14. the train-time augmentation rendered on the card (TPU.TRAIN_DEVICE_AUG):
     a batch of 8 train records' canvases bit for bit equal to the host
     mapper's for the same seeds (flips and 90-degree rotations at unit
     scale), and with the color jitter within one level of the host's
     apply_color_augmentations; DA_STEPS-step do_train runs with the
     augmentation on the host and on the card in turns (host, device,
     device, host), K3 once per step, step ms of each; a few steps with
     the color jitter on the card.
 15. datasets on disk, at the DOTA-1.0 1024 recipe's full width: a DOTA-1.0
     tree in the devkit's layout (16 train and N_FILE_VAL val 1024^2 PNG
     tiles with annotations and planted objects the loader must skip, 8
     unlabeled test tiles cut from 2 originals at stride 824, a DOTA-1.5
     json with container-cranes; rows filtered with each of the five PNG
     filters, one gray, one RGBA and one palette tile) under DAFNE_DATA_DIR;
     every tile decoded bit for bit to the array written, the unfilter
     library equal to its plain version, host ms per tile (read, inflate,
     unfilter); the records' kept and dropped objects as planted; a
     Detectron2 .pth of the whole model and an MSRA R-50.pkl imported (the
     .pth fills every tensor equal to the file, the .pkl exactly the
     backbone); the CLI from the .pkl: FILE_STEPS train steps on
     dota_1_train_1024 (K3 once per step, finite losses, a checkpoint) and
     do_test on dota_1_val_1024 (K1 and greedy once per batch, an mAP, the
     Task1 files); the CLI's --eval-only from the .pth on the unlabeled
     dota_1_test_1024: task1/, task1_merged/ and submission.zip, every
     merged file equal to poly_nms_plain's keep-set on the shifted and
     rescaled tile detections, host seconds of the loop, merge and zip;
     then FILE_AB_STEPS-step do_train runs from the files and from the same
     records with in-memory images in turns (files, memory, memory, files),
     and one batch's host mapping (map_ms) from each.

The line before the last holds one JSON object with every kernel's numbers
(K1's and greedy's launches from phases 4, 11's CLI run, 13's TTA run and
15's two CLI runs, K3's from phases 7, 14 and 15's CLI run, K2's from phase
11's replay; "launches_by_path" splits them); the last line is {"ok": true, "device": {...}}.  Every time printed is
measured in this run, on the card named by the nvidia-smi line: kernel_ms
(and "ms" in the kernels line) on CUDA events around the wrapper's call,
which hold the wrapper's host time when the card waits for the launch;
device_ms (also in the kernels line) from a torch.profiler trace, the
kernel alone.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import pickle
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores and HBM3 bandwidth, used for the bounds
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# F32_FLOPS counts a fused multiply-add as 2 operations.  The kernels are
# built with -fmad=false, so each add, mul or compare is an instruction of
# its own, issued at most once per FP32 lane per cycle: half that rate.
F32_OPS_NO_FMA = F32_FLOPS / 2
# H100 SXM boost clock (data sheet), and the latency of one dependent
# integer ALU step: the greedy walk's serial floor
SM_CLOCK_HZ = 1.98e9
SERIAL_STEP_CYCLES = 4
# kernel names as the profiler reports them
K1_KERNEL, GREEDY_KERNEL = "suppression_bits_kernel", "greedy_keep_bits_kernel"
K2_KERNEL, K3_KERNEL = "suppression_bits_2d_kernel", "assign_argmin_kernel"

# traces per kernel count: a trace drops events now and then, in runs of
# up to 10 of one call's 57 kernels in all 3 traces of a call once
KERNEL_COUNT_TRACES = 8

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8  # main-path batch, and the batch of the kernel checks
N_NMS = 4096  # TPU.NMS_MAX_CANDIDATES: the NMS size of the main path
CANVAS = 1024  # the DOTA-1.0 1024 recipe's test canvas
N_SCENES = 16  # distinct synthetic requests, sent round-robin
WINDOWS, WINDOW_BATCHES = 3, 10  # timed windows of the main path
M_GT = 256  # TPU.MAX_INSTANCES: gt slots per image on the training path
N_TRAIN_SCENES = 16  # synthetic 1024^2 train records
WARMUP_STEPS, TRAIN_STEPS = 3, 20  # training path: untimed, then timed steps
OVERFIT_STEPS = 30
# the recipe's LR during its warm-up (BASE_LR 0.01 x WARMUP_FACTOR 0.1): from
# random weights the full-width model diverges at 0.01 without warm-up
OVERFIT_LR = 0.001
N_EVAL_SCENES = 32  # synthetic_gen1024_val scenes through the eval CLI
GROUP_K = 512  # TPU.NMS_GROUP_CANDIDATES of the eval path
N_TTA_SCENES = 4  # scenes through the TTA CLI
# the DOTA-1.0 1024 recipe's TTA ladder (configs/dota-1.0/1024.yaml): with
# HFLIP and VFLIP, 15 copies per image on canvases 256, 512, 768, 1024, 1536
TTA_MIN_SIZES, TTA_MAX_SIZE = "(256, 512, 756, 1024, 1536)", 1536
WARP_TOL = 1e-3  # rendered TTA copies against the CPU, 0-255 scale
DA_STEPS = 10  # timed steps per run of the device-aug against host-aug comparison
N_FILE_VAL = 32  # val tiles of the DOTA tree on disk (train: the N_TRAIN_SCENES scenes)
FILE_STEPS = 4  # train steps of the CLI run from files
FILE_AB_STEPS = 20  # timed steps per run of the files against in-memory comparison
NARROW = [  # the narrow float32 R-50 of the card-against-CPU checks
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.FPN.OUT_CHANNELS", "32",
    "TPU.COMPUTE_DTYPE", "float32",
]

# the DOTA-1.0 1024 recipe (configs/dota-1.0/1024.yaml over 600.yaml) as
# overrides, since the card has no PyYAML; the recipe's global batch of 8
# runs on the one card (REFERENCE_WORLD_SIZE 0: no rescaling to 1 GPU)
DOTA_1024 = [
    "MODEL.DAFNE.NUM_CLASSES", "15", "MODEL.DAFNE.CENTERNESS_ALPHA", "5",
    "MODEL.DAFNE.LOSS_LAMBDA.CLS", "10.0", "MODEL.DAFNE.LOSS_LAMBDA.CORNERS", "1.0",
    "MODEL.DAFNE.LOSS_LAMBDA.CTR", "1.0",
    "DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
    "DATALOADER.REPEAT_THRESHOLD", "0.2",
    "SOLVER.REFERENCE_WORLD_SIZE", "0", "SOLVER.IMS_PER_BATCH", str(BATCH),
    "SOLVER.BASE_LR", "0.01", "SOLVER.STEPS", "(60000, 80000)", "SOLVER.MAX_ITER", "90000",
    "SOLVER.WARMUP_FACTOR", "0.1", "SOLVER.WARMUP_ITERS", "2000",
    "INPUT.MIN_SIZE_TRAIN", "(1024,)", "INPUT.MAX_SIZE_TRAIN", "1024",
    "INPUT.MAX_SIZE_TEST", "1024", "INPUT.ROTATION_AUG_ANGLES", "[0.0, 90.0, 180.0, 270.0]",
]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
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
    return statistics.median(times)


def device_ms(fn, kernel, reps=20, traces=3):
    """Mean device time per call of fn() of the CUDA kernels whose name
    holds `kernel` ("" for all of them: the device's busy time), from a
    torch.profiler trace of `reps` calls after one warm-up call: the
    kernels alone, without the host time that CUDA events around a call
    (cuda_ms) also hold when the card waits for a launch.  A trace that
    holds no such kernel (the profiler drops one now and then) is taken
    again, up to `traces` times; then None: not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def device_kernels(fn, traces=3):
    """{kernel name: launches} (fills and copies included) of one call of
    fn() on the card, from torch.profiler traces after one warm-up call:
    per name the most of `traces` traces, since a trace drops events now
    and then."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = Counter()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                most[e.key] = max(most[e.key], e.count)
    return most


def fmt_ms(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f}"


def host_ms(fn, reps=3):
    """Median host-clock ms of fn(), synchronised with the card on both ends."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def random_quads(rng, b, n, extent=1024.0):
    """[b, n, 8] rotated rectangles of DOTA-like sizes in a 1024^2 image."""
    cx, cy = rng.uniform(0, extent, (2, b, n))
    w, h = rng.uniform(8, 120, (b, n)), rng.uniform(6, 60, (b, n))
    ang = rng.uniform(0, np.pi, (b, n))
    c, s = np.cos(ang), np.sin(ang)
    pts = []
    for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        px, py = sx * w / 2, sy * h / 2
        pts += [cx + px * c - py * s, cy + px * s + py * c]
    return np.stack(pts, -1).astype(np.float32)


def class_major_mix(rng, b, n, n_valid, n_classes=15, class_major=True):
    """Kernel inputs in the order NMS gives them: ascending class, invalid
    (-1) last, corners CCW (with `class_major` False: in the order drawn,
    which stands for score order).  The valid boxes are jittered copies of
    n/8 cluster seeds and share their seed's class, so S has many nonzeros
    and IoUs near the threshold."""
    from dafne_torch.ops.nms import _as_ccw_rows

    seeds = random_quads(rng, b, max(n // 8, 1))
    seed_cls = rng.randint(0, n_classes, seeds.shape[:2])
    pick = rng.randint(0, seeds.shape[1], (b, n_valid))
    quads = random_quads(rng, b, n)
    quads[:, :n_valid] = np.take_along_axis(seeds, pick[..., None], 1) + rng.uniform(
        -8, 8, (b, n_valid, 8)).astype(np.float32)
    classes = np.full((b, n), -1, np.int32)
    classes[:, :n_valid] = np.take_along_axis(seed_cls, pick, 1)
    if class_major:
        order = np.argsort(np.where(classes < 0, n_classes, classes), axis=1, kind="stable")
        quads = np.take_along_axis(quads, order[..., None], 1)
        classes = np.take_along_axis(classes, order, 1)
    corners = _as_ccw_rows(torch.from_numpy(quads)).cuda().contiguous()
    return corners, torch.from_numpy(classes).cuda()


def suppression_bound(classes, n):
    """((bound ms, bound_by), same-class pairs, ops bound ms without FMA,
    {"bits": ms, "int8": ms}): the larger of the f32 work these inputs need
    (OPS_PER_PAIR for every same-class pair j > i) over F32_FLOPS and the
    bytes (corners and classes read once, S written once as bit rows, N^2 /
    8 bytes, as K1 and K2 write it) over the card's memory rate.  The third
    item is the work over F32_OPS_NO_FMA, the rate the kernels as built can
    reach; the last, the bytes bound of S as bit rows and as int8."""
    from dafne_torch.ops.kernels.quad_nms import OPS_PER_PAIR

    cls = classes.cpu().numpy()
    pairs = 0
    for row in cls:
        counts = np.bincount(row[row >= 0])
        pairs += int((counts * (counts - 1) // 2).sum())
    b = cls.shape[0]
    t_ops = pairs * OPS_PER_PAIR / F32_FLOPS * 1e3
    by_layout = {k: b * (n * 8 * 4 + n * 4 + s) / HBM_BYTES_PER_S * 1e3
                 for k, s in (("bits", n * n // 8), ("int8", n * n))}
    t_bytes = by_layout["bits"]
    bound = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
    return bound, pairs, pairs * OPS_PER_PAIR / F32_OPS_NO_FMA * 1e3, by_layout


def greedy_bound(keep, n):
    """((bound ms, "bytes"), int8 bytes ms, serial floor ms).  The bound is
    the bytes the walk needs: each kept row i's upper-triangle words of the
    bit rows (words i // 32 .. N / 32 - 1, 4 bytes each), plus the keep_init
    read and the keep written; no arithmetic to speak of.  Beside it, the
    same over int8 S (N - 1 - i bytes per kept row), and the serial floor
    the chunked design implies: N / 32 chunks of 32 dependent steps, each at
    least one ALU latency (SERIAL_STEP_CYCLES) at the boost clock."""
    idx = torch.nonzero(keep)[:, 1].cpu().numpy()
    words = n // 32
    word_bytes = int((words - idx // 32).sum()) * 4 + 2 * keep.numel()
    int8_bytes = int((n - 1 - idx).sum()) + 2 * keep.numel()
    floor = words * 32 * SERIAL_STEP_CYCLES / SM_CLOCK_HZ * 1e3
    return ((word_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
            int8_bytes / HBM_BYTES_PER_S * 1e3, floor)


def assign_bound(pairs, k, b, m):
    """((bound ms, bound_by), ops ms over every valid pair, ops bound ms
    without FMA): the larger of the f32 work these inputs need
    (OPS_PER_PAIR for every candidate pair of pair_counts: a location
    inside the gt's clipped center box with its max-ltrb in its size
    range, where only the point-in-quad test is left to decide whether the
    value is finite) over F32_FLOPS and the bytes (20 per location for its point,
    stride and size range, 53 per gt slot, 8 per location and image
    written) over the card's memory rate.  The second item is the bound of
    earlier runs, OPS_PER_PAIR for every (location, valid gt) pair: a
    kernel that culls gts no longer does that work."""
    from dafne_torch.ops.kernels.assign import OPS_PER_PAIR

    t_ops = pairs["candidate"] * OPS_PER_PAIR / F32_FLOPS * 1e3
    t_bytes = (k * 20 + b * m * 53 + b * k * 8) / HBM_BYTES_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
    return (bound, pairs["valid"] * OPS_PER_PAIR / F32_FLOPS * 1e3,
            pairs["candidate"] * OPS_PER_PAIR / F32_OPS_NO_FMA * 1e3)


def full_gts(rng, b, m):
    """gt tensors on the card with all m slots valid: rotated rectangles of
    DOTA-like sizes, canonically sorted."""
    from dafne_torch.geometry.quads import enclosing_hbox, quad_area, sort_quadrilateral

    corners = sort_quadrilateral(torch.from_numpy(random_quads(rng, b, m))).cuda()
    return {"gt_corners": corners, "gt_hbox": enclosing_hbox(corners).contiguous(),
            "gt_classes": torch.from_numpy(rng.randint(0, 15, (b, m)).astype(np.int32)).cuda(),
            "gt_area": quad_area(corners).contiguous(),
            "gt_valid": torch.ones((b, m), dtype=torch.bool, device="cuda")}


def check_assign(spec, tables, g, what, card):
    """K3 against its plain version on the gts `g`: raises unless min_area
    is bit-equal and argmin equal.  Returns (kernel ms, device ms, plain ms,
    bound ms, bound_by, max |min_area diff|, (min_area, argmin))."""
    from dafne_torch.ops.kernels import assign as A

    _, locations, loc_strides, size_ranges = tables
    args = (locations, loc_strides, size_ranges, g["gt_corners"], g["gt_hbox"], g["gt_area"],
            g["gt_valid"], spec)
    km, ka = A.assign_argmin_cuda(*args)
    pm, pa = A.assign_argmin_plain(*args)
    torch.cuda.synchronize()
    err = float((km - pm).abs().max())
    arg_diff = int((ka != pa).sum())
    if not torch.equal(km, pm) or arg_diff:
        raise SystemExit(f"assignment kernel disagrees with its plain version on {what}: "
                         f"max |min_area diff| {err}, {arg_diff} argmin differ")
    (b, m), k = g["gt_valid"].shape, locations.shape[0]
    pairs = A.pair_counts(locations, loc_strides, size_ranges, g["gt_hbox"], g["gt_valid"], spec)
    (bound, by), valid_bound, no_fma = assign_bound(pairs, k, b, m)
    ms = cuda_ms(lambda: A.assign_argmin_cuda(*args))
    dev = device_ms(lambda: A.assign_argmin_cuda(*args), K3_KERNEL)
    plain_ms = cuda_ms(lambda: A.assign_argmin_plain(*args), reps=3, warmup=1)
    log(f"[K3 {what}] B={b} K={k} M={m} valid_gts={int(g['gt_valid'].sum())} "
        f"positives={int((km < A.INF).sum())} differing min_area=0 argmin=0 kernel_ms={ms:.4f} "
        f"device_ms={fmt_ms(dev)} plain_ms={plain_ms:.3f}; pairs: valid {pairs['valid']}, "
        f"listed {pairs['listed']} ({pairs['listed'] / max(pairs['valid'], 1):.4f} of the valid: "
        f"what the pair body runs on), candidate {pairs['candidate']}; bound_ms={bound:.5f} "
        f"({by}; {A.OPS_PER_PAIR} f32 ops per candidate pair) ops_bound_no_fma_ms={no_fma:.5f}; "
        f"earlier bound over every valid pair {valid_bound:.5f} [{card}]")
    return ms, dev, plain_ms, bound, by, err, (km, ka)


def check_k1(corners, classes, thr, what):
    """K1 against its plain version: raises unless the bit rows equal the
    packed plain S word for word.  Returns (bits, plain int8 S)."""
    from dafne_torch.ops.kernels import quad_nms as K

    bits = K.suppression_bits_cuda(corners, classes, thr)
    s_plain = K.suppression_matrix_plain(corners, classes, thr)
    diff = int((bits != K.pack_suppression_bits(s_plain)).sum())
    if diff:
        raise SystemExit(f"K1 disagrees with its packed plain version on {what}: {diff} words")
    return bits, s_plain


def check_greedy(bits, s, keep_init, what):
    """The greedy kernel over `bits` against the plain sequential walk over
    the int8 S they pack: raises unless the keep-sets are equal.  Returns
    the kernel's keep."""
    from dafne_torch.ops.kernels import quad_nms as K

    k_kernel = K.greedy_keep_bits_cuda(bits, keep_init)
    diff = int((k_kernel != K.greedy_keep_plain(s, keep_init)).sum())
    if diff:
        raise SystemExit(f"greedy kernel disagrees with the plain walk on {what}: {diff} entries")
    return k_kernel


def check_k2(corners, classes, what, card):
    """K2 against its plain version, packed, and against K1, which computes
    the same S for any order: raises unless the bit rows are equal word for
    word.  Returns (kernel ms, device ms, plain ms, bound ms, bound_by)."""
    from dafne_torch.ops.kernels import quad_nms as K

    b, n = classes.shape
    bits2 = K.suppression_bits_2d_cuda(corners, classes, 0.1)
    s_plain = K.suppression_matrix_plain(corners, classes, 0.1)
    bits1 = K.suppression_bits_cuda(corners, classes, 0.1)
    torch.cuda.synchronize()
    diff = int((bits2 != K.pack_suppression_bits(s_plain)).sum())
    diff_k1 = int((bits2 != bits1).sum())
    if diff or diff_k1:
        raise SystemExit(f"K2 disagrees on {what}: {diff} words with its packed plain version, "
                         f"{diff_k1} with K1")
    nonzeros = int(s_plain.sum())
    del s_plain
    live = int(K.live_blocks(classes, K.TILE_2D, K.TILE_2D).sum())
    n_tiles = n // K.TILE_2D
    (bound, by), pairs, no_fma, layouts = suppression_bound(classes, n)
    ms = cuda_ms(lambda: K.suppression_bits_2d_cuda(corners, classes, 0.1))
    dev = device_ms(lambda: K.suppression_bits_2d_cuda(corners, classes, 0.1), K2_KERNEL)
    k1_dev = device_ms(lambda: K.suppression_bits_cuda(corners, classes, 0.1), K1_KERNEL)
    plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(corners, classes, 0.1), reps=3, warmup=1)
    log(f"[K2 {what}] B={b} N={n} nonzeros={nonzeros} differing_words=0 (packed plain, and K1) "
        f"live_tiles={live} of {b * n_tiles * (n_tiles + 1) // 2} launched ({K.TILE_2D}^2 tiles "
        f"on or above the diagonal), same-class pairs {pairs} (the pairs it computes) "
        f"kernel_ms={ms:.4f} device_ms={fmt_ms(dev)} K1_device_ms={fmt_ms(k1_dev)} "
        f"plain_ms={plain_ms:.2f} bound_ms={bound:.4f} ({by}; {K.OPS_PER_PAIR} f32 ops per "
        f"same-class pair; S as bit rows, bytes bound {layouts['bits']:.5f}) "
        f"ops_bound_no_fma_ms={no_fma:.4f} [{card}]")
    return ms, dev, plain_ms, bound, by


def match_rate(got, want):
    """(matched, total): how many of `want`'s detections (do_test's
    per-image "preds") have one in `got` of the same image and class, score
    within 1e-4 and corners within 1e-2."""
    matched = total = 0
    for image_id, w in want.items():
        g = got[image_id]
        total += len(w["scores"])
        for c, sc, box in zip(w["classes"], w["scores"], w["corners"]):
            matched += bool(((g["classes"] == c) & (np.abs(g["scores"] - sc) <= 1e-4)
                             & (np.abs(g["corners"] - box).max(1) <= 1e-2)).any())
    return matched, total


def gt_tensors(examples, device):
    from dafne_torch.data.loader import GT_KEYS

    return {k: torch.from_numpy(np.stack([e[k] for e in examples])).to(device) for k in GT_KEYS}


# ---- 15. helpers: PNG files, a DOTA tree and Detectron2 checkpoints ----------

DOTA_10_CLASSES = [  # the DOTA-1.0 categories, in the devkit's id order
    "plane", "baseball-diamond", "bridge", "ground-track-field", "small-vehicle",
    "large-vehicle", "ship", "tennis-court", "basketball-court", "storage-tank",
    "soccer-ball-field", "roundabout", "harbor", "swimming-pool", "helicopter",
]
DOTA_STRIDE = 824  # the devkit's 1024^2 tiles with a 200-pixel gap


def _paeth_predictor(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, samples, color_type, palette=None, filters=(0, 1, 2, 3, 4)):
    """Write uint8 samples [H, W, C] as an 8-bit PNG of `color_type` (0
    gray, 2 RGB, 3 palette indices with `palette` [n, 3] RGB, 4 gray+alpha,
    6 RGBA); row y is filtered with filters[y % len(filters)] (0 None, 1
    Sub, 2 Up, 3 Average, 4 Paeth) and the stream split over IDAT chunks of
    64 KiB."""
    h, w, c = samples.shape
    x = samples.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), x[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    preds = [0, left, up, (left + up) >> 1, _paeth_predictor(left, up, upleft)]
    kinds = np.asarray(filters)[np.arange(h) % len(filters)]
    rows = np.empty((h, w * c + 1), np.uint8)
    rows[:, 0] = kinds
    for f in set(kinds.tolist()):
        sel = kinds == f
        rows[sel, 1:] = ((x - preds[f])[sel] if f else x[sel]) & 0xFF
    stream = zlib.compress(rows.tobytes(), 6)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    out = [b"\x89PNG\r\n\x1a\n", chunk(b"IHDR", ihdr)]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [chunk(b"IDAT", stream[i:i + 65536]) for i in range(0, len(stream), 65536)]
    out.append(chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def write_tile(path, bgr, kind, rng, filters=(0, 1, 2, 3, 4)):
    """Write a BGR image as a PNG of `kind` ("rgb", "gray", "rgba" or
    "palette"), rows filtered as `filters` says; returns the BGR array that
    reading it back must give."""
    rgb = bgr[:, :, ::-1]
    if kind == "gray":
        gray = bgr.mean(axis=2).astype(np.uint8)
        write_png(path, gray[:, :, None], 0, filters=filters)
        return np.repeat(gray[:, :, None], 3, axis=2)
    if kind == "rgba":
        alpha = rng.randint(0, 256, bgr.shape[:2] + (1,)).astype(np.uint8)
        write_png(path, np.concatenate([rgb, alpha], axis=2), 6, filters=filters)
        return bgr.copy()
    if kind == "palette":  # a 3-3-2 palette of 256 colors
        i = np.arange(256)
        palette = np.stack([(i >> 5) * 36, ((i >> 2) & 7) * 36, (i & 3) * 85], 1).astype(np.uint8)
        idx = (rgb[:, :, 0] >> 5 << 5) | (rgb[:, :, 1] >> 5 << 2) | (rgb[:, :, 2] >> 6)
        write_png(path, idx[:, :, None].astype(np.uint8), 3, palette=palette, filters=filters)
        return np.ascontiguousarray(palette[idx][:, :, ::-1])
    write_png(path, np.ascontiguousarray(rgb), 2, filters=filters)
    return bgr.copy()


def _coco_annotation(ann_id, image_id, category_id, seg, area=None, bbox=None):
    xs, ys = seg[0::2], seg[1::2]
    x0, y0 = float(min(xs)), float(min(ys))
    bbox = bbox or [x0, y0, float(max(xs)) - x0, float(max(ys)) - y0]
    return {"id": ann_id, "image_id": image_id, "category_id": category_id, "iscrowd": 0,
            "bbox": bbox, "area": float(bbox[2] * bbox[3] if area is None else area),
            "segmentation": [[float(v) for v in seg]]}


def planted_drops(ann_id, image_id, size):
    """One annotation each that the DOTA loader must skip: area <= MIN_AREA
    (10), both sides below MIN_SIDE (2, with a large stated area), a
    degenerate quad (two corners within 1e-2) and a 6-value polygon."""
    c = size / 2
    return [
        _coco_annotation(ann_id, image_id, 1, [c, c, c + 3, c, c + 3, c + 3, c, c + 3]),
        _coco_annotation(ann_id + 1, image_id, 2, [c, c, c + 1.5, c, c + 1.5, c + 1.5, c, c + 1.5],
                         area=50.0),
        _coco_annotation(ann_id + 2, image_id, 3, [c, c, c + 0.004, c, c + 30, c + 30, c, c + 30]),
        _coco_annotation(ann_id + 3, image_id, 4, [c, c, c + 40, c, c + 20, c + 30]),
    ]


def write_dota_tree(root, train, val, originals, size, stride, rng, tag="1024"):
    """Write a DOTA tree in the devkit's split layout under `root`:
    dota_1_split/{train,val,test}<tag>/DOTA1_<split><tag>.json and
    images/*.png, of size^2 tiles.  `train` and `val` are records (a BGR "image" of size^2,
    "annotations" with "corners" and "category_id" 0-14), written as tiles
    P<n>__1__0___0 with their annotations and, on the first two tiles of
    each, the ``planted_drops``; `originals` are BGR images cut into size^2
    test tiles at `stride` (named as the devkit names them), with no
    annotations.  The first train tile is written gray, the second RGBA and
    the first val tile paletted; the rest RGB.  Also a DOTA-1.5 json over
    the first two train tiles that adds a container-crane to each.
    Returns {"expected": {png path: BGR array}, "counts": {split: (kept,
    dropped)}, "crane": (scene objects, cranes) of the 1.5 json}."""
    categories = [{"id": i + 1, "name": c} for i, c in enumerate(DOTA_10_CLASSES)]
    expected, counts = {}, {}
    ann_id = 1
    jsons = {}
    for split, items in (("train", train), ("val", val), ("test", None)):
        d = os.path.join(root, "dota_1_split", f"{split}{tag}")
        os.makedirs(os.path.join(d, "images"), exist_ok=True)
        images, annotations, kept, dropped = [], [], 0, 0
        if items is None:  # test tiles of the originals
            tiles = []
            for n, img in enumerate(originals):
                for y in range(0, img.shape[0] - size + 1, stride):
                    for x in range(0, img.shape[1] - size + 1, stride):
                        tiles.append((f"P{n + 1:04d}__1__{x}___{y}",
                                      img[y:y + size, x:x + size], []))
        else:
            tiles = [(f"P{n + 1:04d}__1__0___0", r["image"], r["annotations"])
                     for n, r in enumerate(items)]
        for i, (stem, img, annos) in enumerate(tiles):
            kind = {("train", 0): "gray", ("train", 1): "rgba", ("val", 0): "palette"}.get(
                (split, i), "rgb")
            path = os.path.join(d, "images", f"{stem}.png")
            expected[path] = write_tile(path, np.ascontiguousarray(img), kind, rng)
            images.append({"id": i + 1, "file_name": f"{stem}.png", "height": size, "width": size})
            for a in annos:
                annotations.append(_coco_annotation(ann_id, i + 1, a["category_id"] + 1,
                                                    a["corners"]))
                ann_id += 1
            kept += len(annos)
            if items is not None and i < 2:
                drops = planted_drops(ann_id, i + 1, size)
                annotations += drops
                ann_id += len(drops)
                dropped += len(drops)
        doc = {"images": images, "categories": categories}
        if items is not None:
            doc["annotations"] = annotations
        jsons[split] = doc
        with open(os.path.join(d, f"DOTA1_{split}{tag}.json"), "w") as f:
            json.dump(doc, f)
        counts[split] = (kept, dropped)
    # DOTA-1.5: the first two train tiles, each with a container-crane added
    d15 = os.path.join(root, "dota_1_5_split", f"train{tag}")
    os.makedirs(d15, exist_ok=True)
    os.symlink(os.path.join(root, "dota_1_split", f"train{tag}", "images"),
               os.path.join(d15, "images"))
    doc = {"images": jsons["train"]["images"][:2],
           "categories": categories + [{"id": 16, "name": "container-crane"}],
           "annotations": [a for a in jsons["train"]["annotations"] if a["image_id"] <= 2]}
    scene = sum(len(a["annotations"]) for a in train[:2])
    for i in (1, 2):
        c = size / 4
        doc["annotations"].append(_coco_annotation(
            ann_id, i, 16, [c, c, c + 40, c, c + 40, c + 25, c, c + 25]))
        ann_id += 1
    with open(os.path.join(d15, f"DOTA1_5_train{tag}.json"), "w") as f:
        json.dump(doc, f)
    return {"expected": expected, "counts": counts, "crane": (scene, 2)}


def d2_name(name):
    """The port's state-dict name -> its name in a Detectron2 DAFNe
    checkpoint (``head.scales`` is one ``scales.<level>.scale`` per level)."""
    rules = [
        (r"backbone\.stem_conv1(_norm)?\.(\w+)$",
         lambda m: f"backbone.bottom_up.stem.conv1.{'norm.' if m[1] else ''}{m[2]}"),
        (r"backbone\.res(\d)_(\d+)\.(conv\d|shortcut)(_norm)?\.(\w+)$",
         lambda m: f"backbone.bottom_up.res{m[1]}.{m[2]}.{m[3]}.{'norm.' if m[4] else ''}{m[5]}"),
        (r"fpn\.lateral_res(\d)\.(\w+)$", lambda m: f"backbone.fpn_lateral{m[1]}.{m[2]}"),
        (r"fpn\.output_p(\d)\.(\w+)$", lambda m: f"backbone.fpn_output{m[1]}.{m[2]}"),
        (r"fpn\.p(\d)\.(\w+)$", lambda m: f"backbone.top_block.p{m[1]}.{m[2]}"),
        (r"head\.(\w+)_tower\.(conv|norm)(\d+)\.(\w+)$",
         lambda m: f"proposal_generator.dafne_head.{m[1]}_tower."
                   f"{3 * int(m[3]) + (m[2] == 'norm')}.{m[4]}"),
        (r"head\.(\w+)\.(weight|bias)$", lambda m: f"proposal_generator.dafne_head.{m[1]}.{m[2]}"),
    ]
    for pattern, fmt in rules:
        m = re.match(pattern, name)
        if m:
            return fmt(m)
    raise KeyError(name)


def c2_name(name):
    """The port's backbone name -> its name in an MSRA ImageNet pickle
    (``R-50.pkl``); None for what the pickle does not hold (the FrozenBN
    statistics, mean 0 and variance 1, and everything past the backbone)."""
    branch = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c", "shortcut": "branch1"}
    suffix = {"weight": "_w", "norm.weight": "_bn_s", "norm.bias": "_bn_b"}
    m = re.match(r"backbone\.stem_conv1(_norm)?\.(weight|bias)$", name)
    if m:
        return {("", "weight"): "conv1_w", ("_norm", "weight"): "res_conv1_bn_s",
                ("_norm", "bias"): "res_conv1_bn_b"}.get((m[1] or "", m[2]))
    m = re.match(r"backbone\.res(\d)_(\d+)\.(conv\d|shortcut)(_norm)?\.(weight|bias)$", name)
    if m:
        leaf = ("norm." if m[4] else "") + m[5]
        return f"res{m[1]}_{m[2]}_{branch[m[3]]}{suffix[leaf]}" if leaf in suffix else None
    return None


def reference_values(state_dict, rng):
    """Random values for every entry of a port state dict: He-scaled conv
    weights, FrozenBN and GN affines near 1 and 0, positive variances, the
    per-level scales 1.0-1.4 and a class bias of -2 (so NMS inputs fill)."""
    values = {}
    for name, t in state_dict.items():
        shape = tuple(t.shape)
        if len(shape) == 4:
            v = rng.randn(*shape) * np.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        elif name.endswith("running_var"):
            v = rng.rand(*shape) + 0.5
        elif name == "head.scales":
            v = 1.0 + 0.1 * np.arange(shape[0])
        elif name == "head.cls_logits.bias":
            v = np.full(shape, -2.0)
        elif re.search(r"norm\d*\.weight$", name):
            v = rng.rand(*shape) * 0.5 + 0.75
        else:
            v = rng.randn(*shape) * 0.05
        values[name] = v.astype(np.float32)
    return values


def write_reference_checkpoints(values, out_dir):
    """A Detectron2 DAFNe ``.pth`` of every value (torch tensors under the
    Detectron2 names, with the pixel buffers a real checkpoint holds) and an
    MSRA-style ``R-50.pkl`` of the backbone's (numpy, Caffe2 names, with the
    classifier the importer skips).  Returns (pkl path, pth path)."""
    os.makedirs(out_dir, exist_ok=True)
    model = {"pixel_mean": torch.tensor([103.53, 116.28, 123.675]), "pixel_std": torch.ones(3)}
    for name, v in values.items():
        if name == "head.scales":
            for lvl, s in enumerate(v):
                model[f"proposal_generator.dafne_head.scales.{lvl}.scale"] = torch.tensor([s])
        else:
            model[d2_name(name)] = torch.from_numpy(v)
    pth = os.path.join(out_dir, "model_final.pth")
    torch.save({"model": model, "iteration": 90000}, pth)
    blobs = {c2_name(n): v for n, v in values.items() if c2_name(n)}
    blobs["fc1000_w"] = np.zeros((1000, 2048), np.float32)
    blobs["fc1000_b"] = np.zeros(1000, np.float32)
    pkl = os.path.join(out_dir, "R-50.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(blobs, f)
    return pkl, pth


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.data import image_io as IO
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import DatasetMapper
    from dafne_torch.data.synthetic import GEN_CLASSES, load_synthetic_gen
    from dafne_torch.engine import train_loop
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.engine.optimizer import build_optimizer, clip_gradients_
    from dafne_torch.engine.predictor import Predictor
    from dafne_torch.engine.train_loop import do_train, to_device
    from dafne_torch.engine import tta as TTA
    from dafne_torch.engine.trainer import (
        batch_targets,
        device_aug_image,
        flatten_head,
        make_location_tables,
        make_train_step,
    )
    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.kernels import build as kbuild
    from dafne_torch.ops import device_warp as DW
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.losses import LossSpec, dafne_losses
    from dafne_torch.evaluation import build_evaluator
    from dafne_torch.evaluation.result_merge import parse_tile_id
    from dafne_torch.utils import weight_import as W
    from dafne_torch.utils.polyiou import poly_nms_plain
    from dafne_torch.ops.nms import (
        grouped_nms_inputs,
        rotated_nms_grouped_batched,
        single_group_inputs,
        sorted_nms_inputs,
    )
    from dafne_torch.ops.targets import AssignmentSpec
    from dafne_torch.tools.train import main as cli_main
    from dafne_torch.ops.postprocess import (
        DecodeSpec,
        decode_detections,
        decode_single_level,
        nms_candidates,
    )

    # ---- 1. card and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    sources = ("quad_nms", "assign", "png_unfilter")
    with ThreadPoolExecutor(len(sources)) as pool:  # one compiler per source, all at once
        build_logs = dict(zip(sources, pool.map(kbuild.build, sources)))
    log(f"[build] nvcc sm_90a quad_nms.cu, assign.cu and g++ png_unfilter.cpp (the host "
        f"unfilter of phase 15) in parallel: {time.perf_counter() - t0:.1f} s")
    for name, build_log in build_logs.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build {name}] {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(0)
    b, n = BATCH, N_NMS
    # the checks of K1, greedy and K2 exit on any differing word or entry,
    # so a printed kernels line carries 0 for them
    max_err = {"suppression_matrix": 0.0, "greedy_keep": 0.0, "suppression_matrix_2d": 0.0}

    # ---- 2. suppression kernel vs plain ------------------------------------
    s_by_mix = {}
    for mix, n_valid in (("dense-15cls", n), ("25pct-valid", n // 4)):
        corners, classes = class_major_mix(rng, b, n, n_valid)
        bits, s_plain = check_k1(corners, classes, 0.1, mix)
        ms = cuda_ms(lambda: K.suppression_bits_cuda(corners, classes, 0.1))
        dev = device_ms(lambda: K.suppression_bits_cuda(corners, classes, 0.1), K1_KERNEL)
        plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(corners, classes, 0.1), reps=3, warmup=1)
        (bound, by), pairs, no_fma, layouts = suppression_bound(classes, n)
        live = int(K.live_blocks(classes).sum())
        log(f"[K1 {mix}] B={b} N={n} nonzeros={int(s_plain.sum())} differing_words=0 "
            f"live_blocks={live} of {b * (n // K.STRIP) * (n // K.TILE)} kernel_ms={ms:.4f} "
            f"device_ms={fmt_ms(dev)} plain_ms={plain_ms:.2f} bound_ms={bound:.4f} ({by}; same-class pairs {pairs}, "
            f"{K.OPS_PER_PAIR} f32 ops each; S {b * n * n // 8} bytes as bit rows, bytes bound "
            f"{layouts['bits']:.5f}, as int8 {layouts['int8']:.5f}) "
            f"ops_bound_no_fma_ms={no_fma:.4f} [{card}]")
        s_by_mix[mix] = (bits, s_plain, classes >= 0)
    quarter_mix = (corners, classes)  # the 25%-valid mix, for K2 in phase 10

    # ---- 3. greedy kernel vs plain walk ------------------------------------
    chain = torch.from_numpy(np.triu(rng.uniform(size=(n, n)) < 0.002, 1).astype(np.int8))
    links = torch.arange(min(300, n - 1))
    chain[links, links + 1] = 1
    chain = chain[None].cuda().contiguous()
    s_by_mix["chain-300"] = (K.pack_suppression_bits(chain), chain,
                             torch.from_numpy(rng.uniform(size=(1, n)) > 0.05).cuda())
    for mix, (bits, s, keep_init) in s_by_mix.items():
        k_kernel = check_greedy(bits, s, keep_init, mix)
        ms = cuda_ms(lambda: K.greedy_keep_bits_cuda(bits, keep_init))
        dev = device_ms(lambda: K.greedy_keep_bits_cuda(bits, keep_init), GREEDY_KERNEL)
        plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s, keep_init), reps=3, warmup=1)
        (bound, by), int8_bound, floor = greedy_bound(k_kernel, n)
        log(f"[greedy {mix}] B={s.shape[0]} N={n} kept={int(k_kernel.sum())} differing=0 "
            f"kernel_ms={ms:.4f} device_ms={fmt_ms(dev)} plain_ms={plain_ms:.2f} bound_ms={bound:.5f} "
            f"({by}, bit-row words; over int8 S {int8_bound:.5f}) serial_floor_ms={floor:.5f} "
            f"[{card}]")
    del s_by_mix, chain, bits

    # ---- 4. main path ------------------------------------------------------
    torch.backends.cudnn.benchmark = True
    cfg = get_cfg()
    cfg.INPUT.MAX_SIZE_TEST = CANVAS
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    predictor = Predictor(model, cfg, batch=b)
    if predictor.canvas_hw != (CANVAS, CANVAS):
        raise SystemExit(f"canvas {predictor.canvas_hw}, expected {CANVAS}^2")
    t0 = time.perf_counter()
    scenes = [r["image"] for r in load_synthetic_gen("val", N_SCENES, hw=CANVAS, max_boxes=96)]
    log(f"[main] {len(scenes)} synthetic {CANVAS}x{CANVAS} scenes made in "
        f"{time.perf_counter() - t0:.1f} s (host set-up)")
    requests = [scenes[i % len(scenes)] for i in range(WINDOW_BATCHES * b)]
    predictor.detect(requests[:b])  # warm-up: cuDNN algorithm search
    torch.cuda.synchronize()

    K.reset_launch_counts()
    windows_s = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        dets = predictor.detect(requests)
        windows_s.append(time.perf_counter() - t0)  # detect returns host lists: synchronised
    launches = {"suppression_matrix": K.suppression_bits_cuda.launches,
                "greedy_keep": K.greedy_keep_bits_cuda.launches}
    log(f"[main] launches in the main-path run: {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the main path never launched: {launches}")
    if len(dets) != len(requests):
        raise SystemExit("predictor returned the wrong number of results")
    for per_image in dets:
        for d in per_image:
            if not (np.isfinite(d["corners"]).all() and np.isfinite(d["hbox"]).all()
                    and 0.0 < d["score"] <= 1.0 and 0 <= d["class"] < 15):
                raise SystemExit(f"malformed detection {d}")

    # where one request batch's wall time goes, on the host clock
    images = predictor.canvas(requests[:b])
    pinned = images.cpu().pin_memory()
    host = {
        "detect_ms": host_ms(lambda: predictor.detect(requests[:b])),
        "canvas_ms": host_ms(lambda: predictor.canvas(requests[:b])),
        "h2d_ms": host_ms(lambda: pinned.to("cuda", non_blocking=True)),
        "eval_step_ms": host_ms(lambda: predictor.step(images)),
    }
    host["rest_ms"] = host["detect_ms"] - host["canvas_ms"] - host["eval_step_ms"]
    log(f"[main] one batch of {b} through Predictor.detect, host clock, median of 3: "
        f"{json.dumps(host)} (canvas = uint8 fill in pinned memory + copy to the card, of "
        f"which h2d = the copy alone; rest = results to the host and detection dicts) [{card}]")

    # candidate mix and per-phase times on the first batch
    spec = DecodeSpec.from_config(cfg)
    with torch.inference_mode():
        head = model(images)
        pre = sum(
            decode_single_level(head["logits"][i], head["corners"][i], head["ctrness"][i],
                                spec.strides[i], spec)["valid"].sum(1)
            for i in range(len(head["logits"]))
        ).float()
        out = decode_detections(head, spec)
        for key, v in out.items():
            if v.is_floating_point() and not torch.isfinite(v).all():
                raise SystemExit(f"non-finite {key} in the main-path detections")
        cap = spec.nms_max_candidates
        occupancy = float(torch.clamp(pre, max=cap).mean()) / cap
        mix = {
            "pre_cap_candidates_per_img": float(pre.mean()),
            "nms_input_per_img": float(torch.clamp(pre, max=cap).mean()),
            "nms_input_occupancy": occupancy,
            "kept_per_img": float(out["valid"].sum(1).float().mean()),
        }
        log(f"[main] candidate mix {json.dumps(mix)}")
        if occupancy <= 0.25:
            raise SystemExit(f"NMS input occupancy {occupancy} <= 0.25: NMS would be idle")

        cand = nms_candidates(head, spec)
        _, pc, pk, pv = sorted_nms_inputs(cand["corners"], cand["scores"], cand["classes"],
                                          cand["valid"], spec.class_merge, scores01=True)
        model_ms = cuda_ms(lambda: model(images), reps=10, warmup=2)
        decode_ms = cuda_ms(lambda: decode_detections(head, spec), reps=10, warmup=2)
        decode_busy = device_ms(lambda: decode_detections(head, spec), "", reps=10)
        thr = spec.nms_threshold
        bits_main, s_plain = check_k1(pc, pk, thr, "the main path's inputs")
        keep_main = check_greedy(bits_main, s_plain, pv, "the main path's inputs")
        k1_ms = cuda_ms(lambda: K.suppression_bits_cuda(pc, pk, thr))
        k1_plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(pc, pk, thr), reps=3, warmup=1)
        g_ms = cuda_ms(lambda: K.greedy_keep_bits_cuda(bits_main, pv))
        k1_dev = device_ms(lambda: K.suppression_bits_cuda(pc, pk, thr), K1_KERNEL)
        g_dev = device_ms(lambda: K.greedy_keep_bits_cuda(bits_main, pv), GREEDY_KERNEL)
        g_plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s_plain, pv), reps=3, warmup=1)
    (k1_bound, k1_by), pairs, k1_no_fma, k1_layouts = suppression_bound(pk, pk.shape[1])
    (g_bound, g_by), g_int8_bound, g_floor = greedy_bound(keep_main, pk.shape[1])
    k1_live = int(K.live_blocks(pk).sum())
    n_img = WINDOWS * len(requests)
    log(f"[main] R-50 DOTA {CANVAS}x{CANVAS} bf16 batch {b}: {n_img / sum(windows_s):.2f} img/s "
        f"({n_img} requests in {WINDOWS} windows of {WINDOW_BATCHES} batches, "
        f"{sum(windows_s) * 1e3:.1f} ms wall, host included; window seconds "
        f"{windows_s}) [{card}]")
    log(f"[main] per batch of {b}: model_ms={model_ms:.3f} decode_ms={decode_ms:.3f} "
        f"(device busy {fmt_ms(decode_busy, 3)}: the sum of its kernels' device time) "
        f"(of which K1_ms={k1_ms:.4f} greedy_ms={g_ms:.4f}; device alone K1 {fmt_ms(k1_dev)}, "
        f"greedy {fmt_ms(g_dev)}); NMS N={pk.shape[1]}, "
        f"same-class pairs {pairs}, K1 live blocks {k1_live}, kept {int(keep_main.sum())}; "
        f"K1 bound_ms={k1_bound:.4f} ({k1_by}, {K.OPS_PER_PAIR} ops per pair at "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s; bytes bound {k1_layouts['bits']:.5f} as bit rows, "
        f"{k1_layouts['int8']:.5f} as int8), ops_bound_no_fma_ms={k1_no_fma:.4f} (at "
        f"{F32_OPS_NO_FMA / 1e12:.1f} T ops/s); K1 plain_ms={k1_plain_ms:.2f}; greedy "
        f"bound_ms={g_bound:.5f} ({g_by}, bit-row words; over int8 S {g_int8_bound:.5f}) "
        f"serial_floor_ms={g_floor:.5f} plain_ms={g_plain_ms:.2f} [{card}]")

    # the same batch with no candidate cap (TPU.NMS_MAX_CANDIDATES <= 0, the
    # reference's own setting): greedy's shared ring holds 4096 columns of a
    # row, so at this N it also ORs words from global memory
    nspec = dataclasses.replace(spec, nms_max_candidates=0)
    with torch.inference_mode():
        ncand = nms_candidates(head, nspec)
        _, npc, npk, npv = sorted_nms_inputs(ncand["corners"], ncand["scores"], ncand["classes"],
                                             ncand["valid"], nspec.class_merge, scores01=True)
        nbits, ns_plain = check_k1(npc, npk, thr, "the no-cap NMS inputs")
        nkeep = check_greedy(nbits, ns_plain, npv, "the no-cap NMS inputs")
        nout = decode_detections(head, nspec)
        if not all(torch.isfinite(v).all() for v in nout.values() if v.is_floating_point()):
            raise SystemExit("non-finite detections with no candidate cap")
        ng_ms = cuda_ms(lambda: K.greedy_keep_bits_cuda(nbits, npv))
        ng_dev = device_ms(lambda: K.greedy_keep_bits_cuda(nbits, npv), GREEDY_KERNEL)
        nk1_dev = device_ms(lambda: K.suppression_bits_cuda(npc, npk, thr), K1_KERNEL)
        ndecode_ms = cuda_ms(lambda: decode_detections(head, nspec), reps=10, warmup=2)
    (ng_bound, _), ng_int8_bound, ng_floor = greedy_bound(nkeep, npk.shape[1])
    log(f"[main no-cap] the same batch with TPU.NMS_MAX_CANDIDATES 0: NMS N={npk.shape[1]} "
        f"(valid {int(npv.sum())}), K1 bits equal to the packed plain S, greedy equal to the "
        f"plain walk (kept {int(nkeep.sum())}); decode_ms={ndecode_ms:.3f} greedy_ms={ng_ms:.4f} "
        f"device alone greedy {fmt_ms(ng_dev)} K1 {fmt_ms(nk1_dev)}; greedy bound_ms="
        f"{ng_bound:.5f} (bit-row words; over int8 S {ng_int8_bound:.5f}) "
        f"serial_floor_ms={ng_floor:.5f} [{card}]")
    del ncand, nbits, ns_plain, nout

    # ---- 5. small float32 reference: card (kernels) vs CPU (plain) ---------
    small = get_cfg()
    small.merge_from_list(NARROW + [
        "TPU.NMS_MAX_CANDIDATES", "1024", "MODEL.DAFNE.POST_NMS_TOPK_TEST", "300",
    ])
    ref_model = build_model(small, device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref_model.head.cls_logits.bias.fill_(-2.0)
    small_images = torch.from_numpy(
        np.stack([r["image"] for r in load_synthetic_gen("test", 2, hw=256)]).astype(np.float32)
    )
    want = make_eval_step(ref_model, small, (256, 256))(small_images)
    gpu_model = ref_model.to("cuda")
    got = make_eval_step(gpu_model, small, (256, 256))(small_images.cuda())
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.numpy() for k, v in want.items()}
    matched = total = 0
    for i in range(want["valid"].shape[0]):
        wi, gi = np.nonzero(want["valid"][i])[0], np.nonzero(got["valid"][i])[0]
        total += len(wi)
        for j in wi:
            matched += bool((
                (got["classes"][i, gi] == want["classes"][i, j])
                & (np.abs(got["scores"][i, gi] - want["scores"][i, j]) <= 1e-4)
                & (np.abs(got["corners"][i, gi] - want["corners"][i, j]).max(1) <= 1e-2)
            ).any())
    log(f"[reference] narrow R-50 256x256 f32: {matched}/{total} CPU detections matched on the card")
    if total < 100 or matched < 0.99 * total:
        raise SystemExit("the card's detections disagree with the CPU reference")
    del model, predictor, gpu_model, ref_model, head, out, cand, bits_main, s_plain
    torch.cuda.empty_cache()

    # ---- 6. assignment kernel (K3) vs plain -------------------------------
    train_cfg = get_cfg()
    train_cfg.merge_from_list(DOTA_1024)
    train_cfg.OUTPUT_DIR = os.path.join(ROOT, "output", "chip_smoke_train")
    spec = AssignmentSpec.from_config(train_cfg)
    tables = make_location_tables((CANVAS, CANVAS), spec, device="cuda")
    t0 = time.perf_counter()
    train_records = load_synthetic_gen("train", N_TRAIN_SCENES, hw=CANVAS, max_boxes=96)
    log(f"[K3] {len(train_records)} synthetic {CANVAS}x{CANVAS} train scenes made in "
        f"{time.perf_counter() - t0:.1f} s (host set-up)")
    mapper = DatasetMapper(train_cfg, (CANVAS, CANVAS))
    mixes = {"train-scenes": gt_tensors(
        [mapper(r, np.random.RandomState(i)) for i, r in enumerate(train_records[:b])], "cuda")}
    mixes["all-256-valid"] = full_gts(rng, b, M_GT)
    mixes["duplicated"] = {k: torch.cat([v[:, : M_GT // 2]] * 2, 1).contiguous()
                           for k, v in mixes["all-256-valid"].items()}
    max_err["assign_argmin"] = 0.0
    for mix, g in mixes.items():
        *_, err, (km, ka) = check_assign(spec, tables, g, mix, card)
        max_err["assign_argmin"] = max(max_err["assign_argmin"], err)
        if mix == "duplicated" and not (ka[km < A.INF] < M_GT // 2).all():
            raise SystemExit("assignment kernel broke a tie toward the later duplicate")
    del mixes, km, ka

    # ---- 7. training path at full width -----------------------------------
    logging.basicConfig(level=logging.INFO, format="[%(name)s] %(message)s", stream=sys.stdout)
    tmodel = build_model(train_cfg, device="cuda", generator=torch.Generator().manual_seed(2))
    warm = copy.deepcopy(train_cfg)
    warm.SOLVER.MAX_ITER = WARMUP_STEPS
    do_train(warm, tmodel, train_records)  # cuDNN algorithm search, allocator warm-up
    timed = copy.deepcopy(train_cfg)
    timed.SOLVER.MAX_ITER = TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    last = do_train(timed, tmodel, train_records)
    torch.cuda.synchronize()
    save_s = last["checkpoint_s"]  # do_train's final checkpoint save, timed on its own
    train_s = time.perf_counter() - t0 - save_s
    train_launches = A.assign_argmin_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] launches in the training-path run: {{'assign_argmin': {train_launches}}} "
        f"for {TRAIN_STEPS} steps")
    if train_launches != TRAIN_STEPS:
        raise SystemExit(f"K3 launched {train_launches} times in {TRAIN_STEPS} train steps")
    loss_keys = [k for k in last if k.startswith("loss/")]
    if not last["loss_is_finite"] or not all(np.isfinite(last[k]) for k in loss_keys):
        raise SystemExit(f"non-finite training loss: {last}")
    log(f"[train] DOTA-1.0 1024 recipe, R-50 full width, bf16 compute / f32 params, batch {b}, "
        f"{CANVAS}x{CANVAS}, M={M_GT}: {TRAIN_STEPS} steps through do_train in "
        f"{train_s * 1e3:.1f} ms wall (host clock, synchronised; loader start included; the "
        f"final checkpoint save of model, optimizer and scheduler, {save_s * 1e3:.1f} ms, "
        f"excluded): "
        f"step_ms={train_s * 1e3 / TRAIN_STEPS:.2f} img/s={TRAIN_STEPS * b / train_s:.2f}; "
        f"at step {TRAIN_STEPS}: " + json.dumps({k: last[k] for k in loss_keys + ["num_pos", "lr"]})
        + f"; peak memory {peak_gib:.2f} GiB (max_memory_allocated) [{card}]")

    # one step's split, on CUDA events, over a batch from the port's loader
    loader = DataLoader(train_cfg, train_records, b, seed=1, pad_hw=(CANVAS, CANVAS),
                        pin_memory=True)
    batches = iter(loader)
    host_batch = next(batches)
    batches.close()
    with ThreadPoolExecutor(train_cfg.DATALOADER.NUM_WORKERS) as pool:
        map_ms = host_ms(lambda: loader.make_batch(list(range(b)), list(range(b)), pool))
    h2d_ms = host_ms(lambda: to_device(host_batch, "cuda"))
    dev_batch = to_device(host_batch, "cuda")
    optimizer, scheduler = build_optimizer(train_cfg, tmodel)
    loss_spec = LossSpec.from_config(train_cfg)
    names = ("forward", "assignment", "losses", "backward", "optimizer")
    split = {k: [] for k in names}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        out = tmodel(dev_batch["image"])
        ev[1].record()
        targets = batch_targets(dev_batch, spec, tables)
        ev[2].record()
        losses = dafne_losses(*flatten_head(out, loss_spec.num_classes), targets, loss_spec)
        ev[3].record()
        losses["loss/total"].backward()
        ev[4].record()
        clip_gradients_(optimizer, train_cfg)
        optimizer.step()
        scheduler.step()
        ev[5].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            split[k].append(ev[i].elapsed_time(ev[i + 1]))
    split = {f"{k}_ms": statistics.median(v) for k, v in split.items()}
    log(f"[train] one step of batch {b}, CUDA events, median of 5: {json.dumps(split)}; "
        f"data: map_ms={map_ms:.2f} (mapping 8 records on {train_cfg.DATALOADER.NUM_WORKERS} "
        f"threads, host clock; the loader overlaps it with the step) h2d_ms={h2d_ms:.2f} "
        f"[{card}]")
    # K3's numbers for the kernel table, on this main-path batch's gts
    k3_ms, k3_dev, k3_plain_ms, k3_bound, k3_by, err, _ = check_assign(
        spec, tables, dev_batch, "main-path batch", card)
    max_err["assign_argmin"] = max(max_err["assign_argmin"], err)
    del tmodel, optimizer, scheduler, out, targets, losses
    torch.cuda.empty_cache()

    # ---- 8. overfit one fixed batch ----------------------------------------
    ocfg = copy.deepcopy(train_cfg)
    ocfg.merge_from_list(["SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", str(OVERFIT_LR)])
    omodel = build_model(ocfg, device="cuda", generator=torch.Generator().manual_seed(3)).train()
    optimizer, scheduler = build_optimizer(ocfg, omodel)
    step = make_train_step(omodel, ocfg, (CANVAS, CANVAS), optimizer, scheduler)
    totals = [float(step(dev_batch)["loss/total"]) for _ in range(OVERFIT_STEPS)]
    first5, last5 = statistics.mean(totals[:5]), statistics.mean(totals[-5:])
    log(f"[overfit] {OVERFIT_STEPS} steps on one batch of {b}, BASE_LR {OVERFIT_LR}, no warm-up: "
        f"mean total loss of the first 5 {first5:.4f}, of the last 5 {last5:.4f}; "
        f"totals {[round(t, 4) for t in totals]}")
    if not all(np.isfinite(totals)) or not last5 < first5:
        raise SystemExit("the overfit run did not lower the loss")
    del omodel, optimizer, scheduler, step, dev_batch
    torch.cuda.empty_cache()

    # ---- 9. one narrow float32 train step: card (kernel) vs CPU (plain) ---
    ncfg = get_cfg()
    ncfg.merge_from_list(DOTA_1024 + NARROW + [
        "SOLVER.WARMUP_ITERS", "0", "INPUT.MIN_SIZE_TRAIN", "(256,)",
        "INPUT.MAX_SIZE_TRAIN", "256", "SOLVER.IMS_PER_BATCH", "2"])
    nmap = DatasetMapper(ncfg, (256, 256))
    recs = load_synthetic_gen("train", 2, hw=256, max_boxes=24)
    examples = [nmap(r, np.random.RandomState(10 + i)) for i, r in enumerate(recs)]
    results = {}
    cpu_model = build_model(ncfg, device="cpu", generator=torch.Generator().manual_seed(4))
    for dev, m in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        nb = gt_tensors(examples, dev)
        nb["image"] = torch.from_numpy(np.stack([e["image"] for e in examples])).to(dev)
        nspec = AssignmentSpec.from_config(ncfg)
        labels = batch_targets(nb, nspec, make_location_tables((256, 256), nspec, device=dev))[
            "labels"].cpu()
        optimizer, scheduler = build_optimizer(ncfg, m.train())
        metrics = make_train_step(m, ncfg, (256, 256), optimizer, scheduler)(nb)
        results[dev] = (labels, {k: float(v) for k, v in metrics.items()},
                        {k: v.detach().cpu() for k, v in m.state_dict().items()})
    (l_cpu, m_cpu, p_cpu), (l_gpu, m_gpu, p_gpu) = results["cpu"], results["cuda"]
    same_labels = float((l_cpu == l_gpu).float().mean())
    rel = {k: abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
           for k in m_cpu if k.startswith("loss/") or k == "num_pos"}
    p_err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    log(f"[train reference] narrow R-50 f32 batch 2 at 256x256, one step: labels equal on "
        f"{same_labels:.6f} of {l_cpu.numel()} locations; loss relative differences "
        f"{json.dumps(rel)}; max |param diff| after the step {p_err:.3g}; losses (CPU) "
        f"{json.dumps({k: m_cpu[k] for k in rel})}")
    if same_labels < 0.999 or max(rel.values()) > 1e-4 or p_err > 1e-5:
        raise SystemExit("the card's train step disagrees with the CPU reference")

    del cpu_model, results
    torch.cuda.empty_cache()

    # ---- 10. 2-D tiled suppression kernel (K2) vs plain ---------------------
    score_order = class_major_mix(rng, b, n, n, class_major=False)
    for mix, (corners, classes) in (("dense-15cls-score-order", score_order),
                                    ("25pct-valid-class-major", quarter_mix)):
        check_k2(corners, classes, mix, card)
    del score_order, quarter_mix

    # ---- 11. the eval path at full width -----------------------------------
    eval_dir = os.path.join(ROOT, "output", "chip_smoke_eval")
    shutil.rmtree(eval_dir, ignore_errors=True)
    eval_set = "synthetic_gen1024_val"
    eval_args = DOTA_1024 + [
        "INPUT.MIN_SIZE_TEST", str(CANVAS), "DATASETS.TEST", f"('{eval_set}',)",
        "DEBUG.OVERFIT_NUM_IMAGES", str(N_EVAL_SCENES), "TPU.EVAL_BATCH", str(b),
        "TPU.NMS_GROUP_CANDIDATES", str(GROUP_K), "OUTPUT_DIR", eval_dir,
    ]
    ecfg = get_cfg()
    ecfg.merge_from_list(eval_args)
    emodel = build_model(ecfg, device="cuda", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        emodel.head.cls_logits.bias.fill_(-2.0)
    Checkpointer(eval_dir).save(0, emodel)
    register_all_datasets(ecfg)
    t0 = time.perf_counter()
    records = get_dataset(eval_set, ecfg)
    log(f"[eval] {len(records)} of the {eval_set} scenes ({CANVAS}x{CANVAS}, up to 96 objects) "
        f"made in {time.perf_counter() - t0:.1f} s (host set-up)")
    n_batches = -(-len(records) // b)
    K.reset_launch_counts()
    eval_stats = {}
    t0 = time.perf_counter()
    results = cli_main(["--eval-only"] + eval_args, stats=eval_stats)
    cli_s = time.perf_counter() - t0
    eval_launches = {"suppression_matrix": K.suppression_bits_cuda.launches,
                     "greedy_keep": K.greedy_keep_bits_cuda.launches}
    log(f"[eval] launches in the eval-path run ({n_batches} batches): {eval_launches}")
    if set(eval_launches.values()) != {n_batches}:
        raise SystemExit(f"grouped decode did not launch K1 and greedy once per batch: {eval_launches}")
    inference = os.path.join(eval_dir, "inference", eval_set)
    written = [os.path.join(inference, "results.txt"), os.path.join(eval_dir, "test_results.csv")]
    written += [os.path.join(inference, "task1", f"Task1_{c}.txt") for c in GEN_CLASSES]
    missing = [f for f in written if not os.path.exists(f)]
    st = eval_stats[eval_set]
    if missing or len(st["preds"]) != len(records) or st["images"] != len(records):
        raise SystemExit(f"the eval CLI did not write {missing} or missed images")
    n_img, loop_s, evaluate_s = st["images"], st["loop_s"], st["evaluate_s"]
    phase11_img_s = n_img / loop_s
    log(f"[eval] CLI --eval-only on {n_img} scenes in {cli_s:.2f} s wall (model build, checkpoint "
        f"restore, data, eval, files): do_test loop (map, model, decode, fetch) {loop_s:.3f} s = "
        f"{n_img / loop_s:.2f} img/s; evaluate() {evaluate_s:.3f} s = {n_img / evaluate_s:.2f} "
        f"img/s (host clock); mAP {results[eval_set]['mAP']:.4f} (random weights: no meaning "
        f"beyond the files being right); {len(written)} files written [{card}]")

    # one batch's decode through both NMS paths, and every batch's NMS input
    gspec = DecodeSpec.from_config(ecfg)
    cspec = dataclasses.replace(gspec, nms_group_candidates=0)
    min_total = max(gspec.nms_max_candidates, gspec.post_nms_topk)
    thr = gspec.nms_threshold
    cands = []
    with torch.inference_mode():
        for batch in DataLoader(ecfg, records, b, pad_hw=(CANVAS, CANVAS), pin_memory=True,
                                train=False):
            head = emodel(batch["image"].to("cuda", non_blocking=True))
            cands.append({k: v for k, v in nms_candidates(head, gspec).items()
                          if k in ("corners", "scores", "classes", "valid")})
            if len(cands) == 1:
                head0 = head
        c0 = cands[0]
        gpc, gpk, gpv = single_group_inputs(*grouped_nms_inputs(
            c0["corners"], c0["scores"], c0["classes"], c0["valid"], gspec.class_merge,
            gspec.num_classes, gspec.nms_group_candidates, min_total)[1:])
        cc = nms_candidates(head0, cspec)
        _, cpc, cpk, cpv = sorted_nms_inputs(cc["corners"], cc["scores"], cc["classes"],
                                             cc["valid"], cspec.class_merge, scores01=True)
        split = {}
        for path, spec_, (pc, pk, pv) in (("grouped", gspec, (gpc, gpk, gpv)),
                                          ("global-cap", cspec, (cpc, cpk, cpv))):
            bits_ = K.suppression_bits_cuda(pc, pk, thr)
            split[path] = {
                "decode_ms": cuda_ms(lambda: decode_detections(head0, spec_), reps=10, warmup=2),
                "decode_device_busy_ms": device_ms(lambda: decode_detections(head0, spec_), "",
                                                   reps=10),
                "K1_ms": cuda_ms(lambda: K.suppression_bits_cuda(pc, pk, thr)),
                "greedy_ms": cuda_ms(lambda: K.greedy_keep_bits_cuda(bits_, pv)),
                "nms_rows": list(pk.shape),
                "kept_per_img": float(decode_detections(head0, spec_)["valid"].sum(1).float().mean()),
            }
        pre = sum(decode_single_level(head0["logits"][i], head0["corners"][i], head0["ctrness"][i],
                                      gspec.strides[i], gspec)["valid"].sum(1)
                  for i in range(len(head0["logits"]))).float()
    k_slots = gpv.shape[0] * GROUP_K
    occupancy = gpv.sum(1).float() / GROUP_K
    eval_mix = {"per_level_survivors_per_img": float(pre.mean()),
                "group_occupancy_mean": float(occupancy.mean()),
                "groups_full": int((occupancy == 1.0).sum()), "groups": gpv.shape[0],
                "valid_slots": int(gpv.sum()), "slots": k_slots}
    log(f"[eval] one batch of {b}, CUDA events (decode median of 10, kernels of 20): "
        f"{json.dumps(split)}; candidate mix {json.dumps(eval_mix)} [{card}]")
    if eval_mix["group_occupancy_mean"] <= 0.5:
        raise SystemExit(f"grouped NMS input occupancy {eval_mix['group_occupancy_mean']}: too idle")

    # K1 against its packed plain version and the greedy kernel against the
    # plain walk at the eval path's own shape, [B * G, K], on every batch
    with torch.inference_mode():
        g_kept = 0
        for i, c in enumerate(cands):
            pc, pk, pv = single_group_inputs(*grouped_nms_inputs(
                c["corners"], c["scores"], c["classes"], c["valid"], gspec.class_merge,
                gspec.num_classes, GROUP_K, min_total)[1:])
            bits_, s_ = check_k1(pc, pk, thr, f"grouped eval batch {i}")
            k_kernel = check_greedy(bits_, s_, pv, f"grouped eval batch {i}")
            g_kept += int(k_kernel.sum())
        # times and bounds on the last batch
        gk1_ms = cuda_ms(lambda: K.suppression_bits_cuda(pc, pk, thr))
        gk1_dev = device_ms(lambda: K.suppression_bits_cuda(pc, pk, thr), K1_KERNEL)
        gg_dev = device_ms(lambda: K.greedy_keep_bits_cuda(bits_, pv), GREEDY_KERNEL)
        gk1_plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(pc, pk, thr), reps=3, warmup=1)
        (gk1_bound, gk1_by), gpairs, gk1_no_fma, _ = suppression_bound(pk, pk.shape[1])
        gg_ms = cuda_ms(lambda: K.greedy_keep_bits_cuda(bits_, pv))
        gg_plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s_, pv), reps=3, warmup=1)
        (gg_bound, gg_by), gg_int8_bound, gg_floor = greedy_bound(k_kernel, pv.shape[1])
        g_live = int(K.live_blocks(pk).sum())
    log(f"[K1 grouped eval] {len(cands)} batches of [B*G, K]={list(pk.shape)}: bit rows equal to "
        f"the packed plain S (differing_words=0); last batch kernel_ms={gk1_ms:.4f} "
        f"device_ms={fmt_ms(gk1_dev)} "
        f"plain_ms={gk1_plain_ms:.2f} bound_ms={gk1_bound:.5f} ({gk1_by}; same-class pairs "
        f"{gpairs}) ops_bound_no_fma_ms={gk1_no_fma:.5f} live_blocks={g_live} [{card}]")
    log(f"[greedy grouped eval] {len(cands)} batches of [B*G, K]={list(pv.shape)}: kept {g_kept}, "
        f"differing=0; last batch kernel_ms={gg_ms:.4f} device_ms={fmt_ms(gg_dev)} "
        f"plain_ms={gg_plain_ms:.2f} "
        f"bound_ms={gg_bound:.5f} ({gg_by}, bit-row words; over int8 S {gg_int8_bound:.5f}) "
        f"serial_floor_ms={gg_floor:.5f} [{card}]")

    # K2 on the eval path: a replay of every batch's grouped NMS with
    # impl="pallas-2d".  No config key reaches `impl` (none does in the JAX
    # package either), so the CLI's run never launches K2; its launches in
    # the kernels line are this replay's.
    K.reset_launch_counts()
    keeps_2d = [rotated_nms_grouped_batched(c["corners"], c["scores"], c["classes"], c["valid"],
                                            thr, gspec.class_merge, gspec.num_classes, GROUP_K,
                                            min_total, impl="pallas-2d") for c in cands]
    torch.cuda.synchronize()
    k2_launches = K.suppression_bits_2d_cuda.launches
    keeps = [rotated_nms_grouped_batched(c["corners"], c["scores"], c["classes"], c["valid"],
                                         thr, gspec.class_merge, gspec.num_classes, GROUP_K,
                                         min_total, impl="pallas") for c in cands]
    differ = sum(int((k2 != k1).sum()) for k2, k1 in zip(keeps_2d, keeps))
    # K2 hands its bit rows to the greedy kernel as K1 does: no int8 S, no
    # fill and no pack, so beside K2 for K1 the two impls run the same kernels
    per_impl = {impl: device_kernels(lambda: rotated_nms_grouped_batched(
        c0["corners"], c0["scores"], c0["classes"], c0["valid"], thr, gspec.class_merge,
        gspec.num_classes, GROUP_K, min_total, impl=impl), traces=KERNEL_COUNT_TRACES)
        for impl in ("pallas", "pallas-2d")}
    extra = {k: n - per_impl["pallas"][k] for k, n in per_impl["pallas-2d"].items()
             if K2_KERNEL not in k and n > per_impl["pallas"][k]}
    log(f"[eval] replay of the grouped NMS of {len(cands)} batches with impl=pallas-2d: K2 launches "
        f"{k2_launches}; keep-sets differing from impl=pallas: {differ} of "
        f"{sum(int(k.sum()) for k in keeps)} kept; kernels per grouped NMS call (profiler): "
        f"pallas {sum(per_impl['pallas'].values())}, pallas-2d "
        f"{sum(per_impl['pallas-2d'].values())}, beside K2 none more than pallas's: {not extra}")
    if differ or k2_launches != len(cands):
        raise SystemExit("K2's grouped keep-sets disagree with K1's, or K2 did not launch")
    if extra:
        raise SystemExit(f"impl=pallas-2d runs kernels that impl=pallas does not: {extra}")
    k2_ms, k2_dev, k2_plain_ms, k2_bound, k2_by = check_k2(gpc, gpk, "grouped eval batch [B*G, K]",
                                                           card)
    del head0, cands, keeps_2d, keeps  # emodel stays for phase 13
    torch.cuda.empty_cache()

    # ---- 12. narrow float32 do_test: card (kernels) vs CPU (plain) -----------
    rcfg = get_cfg()
    rcfg.merge_from_list(NARROW + [
        "DATASETS.TEST", "('synthetic_gen_val',)", "DEBUG.OVERFIT_NUM_IMAGES", "8",
        "INPUT.MIN_SIZE_TEST", "256", "INPUT.MAX_SIZE_TEST", "256", "TPU.EVAL_BATCH", str(b),
        "TPU.NMS_GROUP_CANDIDATES", "64", "TPU.NMS_MAX_CANDIDATES", "1024",
        "MODEL.DAFNE.POST_NMS_TOPK_TEST", "300", "TEST.NUM_PRED_VIS", "0",
    ])
    register_all_datasets(rcfg)
    ref = build_model(rcfg, device="cpu", generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        ref.head.cls_logits.bias.fill_(-2.0)
    preds, maps = {}, {}
    for dev, mdl in (("cpu", ref), ("cuda", copy.deepcopy(ref).to("cuda"))):
        st = {}
        maps[dev] = train_loop.do_test(rcfg, mdl, stats=st)["synthetic_gen_val"]["mAP"]
        preds[dev] = st["synthetic_gen_val"]["preds"]
    matched, total = match_rate(preds["cuda"], preds["cpu"])
    # the evaluator on the ground truth as detections (score 1), and on
    # jittered ground truth (a fifth of it far off) plus false positives,
    # with mixed scores: the first must score 100, the second in between
    gt_records = get_dataset("synthetic_gen_val", rcfg)
    gt_eval = build_evaluator(rcfg, "synthetic_gen_val", gt_records)
    mixed_eval = build_evaluator(rcfg, "synthetic_gen_val", gt_records)
    erng = np.random.RandomState(7)
    for r in gt_records:
        gts = np.asarray([a["corners"] for a in r["annotations"]], np.float64)
        cls = np.asarray([a["category_id"] for a in r["annotations"]])
        k = len(cls)
        gt_eval.process_image(r["image_id"], gts, np.ones(k), cls, np.ones(k, bool))
        far = np.where(erng.rand(k, 1) < 0.2, 40.0, 1.0)
        corners = np.concatenate([gts + erng.uniform(-1, 1, gts.shape) * far,
                                  random_quads(erng, 1, 4, extent=256.0)[0]])
        classes = np.concatenate([cls, erng.randint(0, len(GEN_CLASSES), 4)])
        mixed_eval.process_image(r["image_id"], corners, erng.rand(k + 4), classes,
                                 np.ones(k + 4, bool))
    gt_map, mixed_map = gt_eval.evaluate()["mAP"], mixed_eval.evaluate()["mAP"]
    log(f"[eval reference] narrow R-50 f32, 8 scenes 256x256, grouped NMS: {matched}/{total} CPU "
        f"detections matched on the card; mAP card {maps['cuda']:.4f} CPU {maps['cpu']:.4f} "
        f"(random weights); ground truth as detections mAP {gt_map:.4f}; jittered ground truth "
        f"and false positives mAP {mixed_map:.4f}")
    if total < 100 or matched < 0.99 * total or abs(maps["cuda"] - maps["cpu"]) > 0.1:
        raise SystemExit("the card's eval path disagrees with the CPU reference")
    if abs(gt_map - 100.0) > 1e-9:  # eleven 1/11 steps of VOC-07 sum to 1 + 2e-16
        raise SystemExit(f"the evaluator scores the ground truth at mAP {gt_map}, not 100")
    if not 0.0 < mixed_map < 100.0:
        raise SystemExit(f"the evaluator scores jittered ground truth and false positives at "
                         f"mAP {mixed_map}, not strictly between 0 and 100")

    # ---- 13. TTA at full width: the DOTA-1.0 1024 recipe's ladder ------------
    tta_args = eval_args + ["DEBUG.OVERFIT_NUM_IMAGES", str(N_TTA_SCENES), "TEST.AUG.ENABLED",
                            "True", "TEST.AUG.MIN_SIZES", TTA_MIN_SIZES, "TEST.AUG.MAX_SIZE",
                            str(TTA_MAX_SIZE)]
    tcfg = get_cfg()
    tcfg.merge_from_list(tta_args)
    tta_records = get_dataset(eval_set, tcfg)
    do_batches = -(-len(tta_records) // b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tta_stats = {}
    t0 = time.perf_counter()
    results = cli_main(["--eval-only"] + tta_args, tta_stats=tta_stats)
    tta_cli_s = time.perf_counter() - t0
    tta_launches = {"suppression_matrix": K.suppression_bits_cuda.launches,
                    "greedy_keep": K.greedy_keep_bits_cuda.launches}
    tta_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ts = tta_stats[eval_set]
    tta_steps = sum(sum(p["steps"].values()) for p in ts["per_image"])
    log(f"[tta] launches in the CLI run (do_test: {do_batches} batch; TTA: {tta_steps} eval "
        f"steps): {tta_launches}")
    if set(tta_launches.values()) != {do_batches + tta_steps}:
        raise SystemExit(f"K1 and greedy did not launch once per eval step: {tta_launches}")
    tta_launches = {k: v - do_batches for k, v in tta_launches.items()}  # TTA's own
    inference_tta = os.path.join(eval_dir, "inference_tta", eval_set)
    written = [os.path.join(inference_tta, "results.txt")]
    written += [os.path.join(inference_tta, "task1", f"Task1_{c}.txt") for c in GEN_CLASSES]
    missing = [f for f in written if not os.path.exists(f)]
    if missing or "mAP" not in results["tta"][eval_set] or ts["images"] != len(tta_records):
        raise SystemExit(f"the TTA run did not write {missing} or missed images")
    want_steps = {256: 1, 512: 1, 768: 1, 1024: 1, 1536: 3}  # batches 8, 8, 7, 4, 1
    topk = tcfg.MODEL.DAFNE.POST_NMS_TOPK_TEST
    for i, st in enumerate(ts["per_image"]):
        if st["copies"] != 15 or st["steps"] != want_steps or not 0 < st["boxes_out"] <= topk:
            raise SystemExit(f"TTA image {i}: {st['copies']} copies, steps {st['steps']}, "
                             f"{st['boxes_out']} boxes out")
        log(f"[tta] image {i}: {st['copies']} copies; warp {st['warp_ms']:.3f} ms (CUDA events); "
            f"eval steps per canvas (CUDA events, ms) "
            f"{json.dumps({c: round(v, 3) for c, v in st['eval_ms'].items()})}, steps "
            f"{json.dumps(st['steps'])}; fetch {st['fetch_ms']:.3f} ms and merge "
            f"{st['merge_ms']:.3f} ms (host clock); boxes into the merge {st['boxes_in']}, out "
            f"{st['boxes_out']} [{card}]")
    for image_id, det in ts["preds"].items():
        if not (np.isfinite(det["corners"]).all() and ((det["scores"] > 0) & (det["scores"] <= 1)).all()
                and ((det["classes"] >= 0) & (det["classes"] < 15)).all()):
            raise SystemExit(f"malformed TTA detections for {image_id}")
    split = {k: statistics.mean(p[k] for p in ts["per_image"])
             for k in ("warp_ms", "fetch_ms", "merge_ms", "boxes_in", "boxes_out")}
    split["eval_ms"] = statistics.mean(sum(p["eval_ms"].values()) for p in ts["per_image"])
    later = [p["wall_ms"] for p in ts["per_image"][1:]]  # the first pays cuDNN's search
    log(f"[tta] CLI --eval-only TEST.AUG.ENABLED True on {ts['images']} scenes ({CANVAS}x{CANVAS}, "
        f"MIN_SIZES {TTA_MIN_SIZES}, MAX_SIZE {TTA_MAX_SIZE}, HFLIP and VFLIP: 15 copies each) in "
        f"{tta_cli_s:.2f} s wall (model build, restore, do_test, TTA, files): TTA loop "
        f"{ts['loop_s']:.3f} s = {ts['loop_s'] / ts['images']:.3f} s/image (per image "
        f"{[round(p['wall_ms'], 1) for p in ts['per_image']]} ms, host clock; after the first "
        f"{statistics.mean(later) / 1e3:.3f} s/image); mean per image "
        f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; evaluate() "
        f"{ts['evaluate_s']:.3f} s; peak memory {tta_peak_gib:.2f} GiB (max_memory_allocated; "
        f"canvas 1536 at batch 1) [{card}]")

    # one batch per canvas of the first scene: the rendered copies against the
    # same gathers on the CPU, and K1 and greedy against their plain versions
    emodel.eval()
    steps = TTA.BucketedEvalSteps(tcfg, emodel)
    tspec = DecodeSpec.from_config(tcfg)
    img0 = tta_records[0]["image"]
    h0, w0 = img0.shape[:2]
    groups = {}
    for aug in TTA.build_tta_augs(tcfg, w0, h0):
        side = steps._canvas_for(max(aug.out_h, aug.out_w))
        q = DW.separable_warp_params(aug, w0, h0, (side, side))
        groups.setdefault((side, q.transpose), []).append((aug, q))
    if h0 % steps.div or w0 % steps.div:
        raise SystemExit(f"scene {h0}x{w0} is off the divisibility grid: the base needs padding")
    base_cpu = torch.from_numpy(img0)
    base_dev = base_cpu.cuda()
    tta_canvas = {}
    with torch.inference_mode():
        for (side, transpose), items in sorted(groups.items()):
            _, _, bsz = steps.get_fused((h0, w0), (side, side), transpose)
            chunk = items[:bsz]
            chunk += [chunk[-1]] * (bsz - len(chunk))  # padded as tta_inference_single pads
            p = DW.stack_warps([q for _, q in chunk])
            wt = DW.warp_tensors(p, "cuda")
            imgs = DW.device_warp(base_dev, wt, transpose)
            ref = DW.device_warp(base_cpu, DW.warp_tensors(p, "cpu"), transpose)
            err = float((imgs.cpu() - ref).abs().max())
            exact = 0
            for i, (aug, q) in enumerate(items[:bsz]):
                if (q.out_h, q.out_w) == (h0, w0):  # unit scale: a permutation copy
                    host = torch.from_numpy(aug.apply_image(img0).astype(np.float32))
                    if not (torch.equal(imgs[i].cpu(), host) and torch.equal(ref[i], host)):
                        raise SystemExit(f"TTA copy {i} at canvas {side} is not the exact "
                                         "permutation of the image")
                    exact += 1
            if err > WARP_TOL:
                raise SystemExit(f"TTA copies at canvas {side} differ from the CPU by {err}")
            warp_ms = cuda_ms(lambda: DW.device_warp(base_dev, wt, transpose), reps=10, warmup=2)
            c = nms_candidates(emodel(imgs), tspec)
            pc, pk, pv = single_group_inputs(*grouped_nms_inputs(
                c["corners"], c["scores"], c["classes"], c["valid"], tspec.class_merge,
                tspec.num_classes, tspec.nms_group_candidates,
                max(tspec.nms_max_candidates, tspec.post_nms_topk))[1:])
            bits_, s_ = check_k1(pc, pk, thr, f"TTA canvas {side}")
            kept = int(check_greedy(bits_, s_, pv, f"TTA canvas {side}").sum())
            k1_t = cuda_ms(lambda: K.suppression_bits_cuda(pc, pk, thr), reps=10)
            tta_canvas[side] = {"batch": bsz, "copies": min(bsz, len(items)), "nms_rows": list(pk.shape),
                                "valid_slots": int(pv.sum()), "kept": kept, "warp_ms": round(warp_ms, 4),
                                "K1_ms": round(k1_t, 4), "max_abs_err_vs_cpu": err,
                                "exact_permutation_copies": exact}
    log(f"[tta] one batch per canvas of scene 0: copies within {WARP_TOL} of the same gathers on "
        f"the CPU (0-255 scale), the unit-scale permutation copies bit for bit; K1's bits equal to "
        f"the packed plain S and greedy equal to the plain walk on every canvas: "
        f"{json.dumps(tta_canvas)} [{card}]")
    if sum(v["exact_permutation_copies"] for v in tta_canvas.values()) != 3:
        raise SystemExit("the canvas-1024 identity, hflip and vflip copies were not all checked")
    del steps, base_dev, imgs, ref, bits_, s_, emodel
    torch.cuda.empty_cache()

    # the narrow float32 model's TTA on the card (kernels) and on the CPU (plain)
    ntcfg = get_cfg()
    ntcfg.merge_from_list(NARROW + [
        "TEST.AUG.MIN_SIZES", "(128, 256)", "TEST.AUG.MAX_SIZE", "256",
        "TPU.NMS_GROUP_CANDIDATES", "64", "TPU.NMS_MAX_CANDIDATES", "1024",
        "MODEL.DAFNE.POST_NMS_TOPK_TEST", "300"])
    nref = build_model(ntcfg, device="cpu", generator=torch.Generator().manual_seed(8)).eval()
    with torch.no_grad():
        nref.head.cls_logits.bias.fill_(-2.0)
    nimg = load_synthetic_gen("test", 1, hw=256)[0]["image"]
    want = TTA.tta_inference_single(ntcfg, TTA.BucketedEvalSteps(ntcfg, nref), nimg)
    got = TTA.tta_inference_single(ntcfg, TTA.BucketedEvalSteps(ntcfg, copy.deepcopy(nref).cuda()),
                                   nimg)
    matched, total = match_rate({"0": got}, {"0": want})
    log(f"[tta reference] narrow R-50 f32, one 256x256 scene, 6 copies (128 and 256): "
        f"{matched}/{total} CPU detections matched on the card ({len(got['scores'])} on the card)")
    if total < 100 or matched < 0.99 * total:
        raise SystemExit("the card's TTA disagrees with the CPU reference")

    # ---- 14. train-time augmentation rendered on the card -------------------
    da_cfg, host_cfg = copy.deepcopy(train_cfg), copy.deepcopy(train_cfg)
    da_cfg.TPU.TRAIN_DEVICE_AUG, host_cfg.TPU.TRAIN_DEVICE_AUG = True, False
    idx = list(range(b))
    seeds = [100 + i for i in idx]
    for color in (False, True):
        for c_ in (da_cfg, host_cfg):
            c_.INPUT.USE_COLOR_AUGMENTATIONS = color
        da_loader = DataLoader(da_cfg, train_records, b, pad_hw=(CANVAS, CANVAS), pin_memory=True,
                               device_aug=True)
        host_loader = DataLoader(host_cfg, train_records, b, pad_hw=(CANVAS, CANVAS),
                                 pin_memory=True)
        da_batch = da_loader.make_batch(idx, seeds)
        want_img = host_loader.make_batch(idx, seeds)["image"].float()
        dev = to_device(da_batch, "cuda")
        got_img = device_aug_image(dev, color).cpu()
        render_ms = cuda_ms(lambda: device_aug_image(dev, color), reps=10, warmup=2)
        diff = (got_img - want_img).abs()
        transposed = sum(not torch.equal(da_batch["image_base"][i], torch.from_numpy(
            da_loader.records[i]["image"])) for i in idx)
        log(f"[train device-aug] batch of {b} records, seeds {seeds[0]}-{seeds[-1]}, color jitter "
            f"{color}: canvas rendered on the card vs the host mapper's: max |diff| "
            f"{float(diff.max())} levels, equal on {float((diff == 0).float().mean()):.6f} of the "
            f"values; {transposed} draws anti-diagonal (base transposed on the host); render "
            f"{render_ms:.3f} ms (CUDA events, median of 10) [{card}]")
        if float(diff.max()) > (1.0 if color else 0.0):
            raise SystemExit(f"the device-rendered train canvas differs from the host's "
                             f"(color {color}) by {float(diff.max())}")
    da_cfg.INPUT.USE_COLOR_AUGMENTATIONS = host_cfg.INPUT.USE_COLOR_AUGMENTATIONS = False
    damodel = build_model(train_cfg, device="cuda", generator=torch.Generator().manual_seed(9))
    warm = copy.deepcopy(da_cfg)
    warm.SOLVER.MAX_ITER = WARMUP_STEPS
    do_train(warm, damodel, train_records)
    step_ms = {"host": [], "device": []}
    da_launches = 0
    for where in ("host", "device", "device", "host"):
        c_ = copy.deepcopy(da_cfg if where == "device" else host_cfg)
        c_.SOLVER.MAX_ITER = DA_STEPS
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        last = do_train(c_, damodel, train_records)
        torch.cuda.synchronize()
        step_ms[where].append((time.perf_counter() - t0 - last["checkpoint_s"]) * 1e3 / DA_STEPS)
        if A.assign_argmin_cuda.launches != DA_STEPS or not last["loss_is_finite"]:
            raise SystemExit(f"{where}-aug do_train: K3 launched {A.assign_argmin_cuda.launches} "
                             f"times in {DA_STEPS} steps, losses {last}")
        if where == "device":
            da_launches += A.assign_argmin_cuda.launches
    colored = copy.deepcopy(da_cfg)
    colored.INPUT.USE_COLOR_AUGMENTATIONS = True
    colored.SOLVER.MAX_ITER = WARMUP_STEPS
    last = do_train(colored, damodel, train_records)
    if not last["loss_is_finite"]:
        raise SystemExit(f"device-aug do_train with color jitter: non-finite loss {last}")
    log(f"[train device-aug] DOTA-1.0 1024 recipe, R-50 full width, batch {b}: step_ms with the "
        f"augmentation rendered on the card {[round(v, 2) for v in step_ms['device']]} beside "
        f"the host's {[round(v, 2) for v in step_ms['host']]} (runs of {DA_STEPS} steps through "
        f"do_train in the order host, device, device, host; host clock, synchronised, loader start "
        f"included, checkpoint save excluded); K3 launched once per step; {WARMUP_STEPS} steps with "
        f"color jitter on the card: loss/total {last['loss/total']:.4f} [{card}]")
    del damodel
    torch.cuda.empty_cache()

    # ---- 15. datasets on disk: the DOTA-1.0 1024 recipe through the CLI ------
    files_dir = os.path.join(ROOT, "output", "chip_smoke_files")
    shutil.rmtree(files_dir, ignore_errors=True)
    data_dir = os.path.join(files_dir, "data")
    os.environ["DAFNE_DATA_DIR"] = data_dir  # read when the CLI registers the datasets
    t0 = time.perf_counter()
    val_scenes = load_synthetic_gen("val", N_FILE_VAL, hw=CANVAS, max_boxes=96)
    originals = [r["image"] for r in load_synthetic_gen("test", 2, hw=CANVAS + DOTA_STRIDE,
                                                        max_boxes=96)]
    tree = write_dota_tree(data_dir, train_records, val_scenes, originals, CANVAS, DOTA_STRIDE,
                           np.random.RandomState(15))
    log(f"[files] DOTA-1.0 tree of {len(tree['expected'])} {CANVAS}x{CANVAS} PNG tiles "
        f"({len(train_records)} train, {N_FILE_VAL} val, 8 test from 2 originals of "
        f"{CANVAS + DOTA_STRIDE}^2 at stride {DOTA_STRIDE}; rows filtered None, Sub, Up, Average, "
        f"Paeth in turn; one gray, one RGBA, one palette tile) written in "
        f"{time.perf_counter() - t0:.1f} s (host set-up)")

    # every tile decodes to the array written; the library equals its plain version
    parts = {"read_image": [], "inflate": [], "unfilter": []}
    for path, want in tree["expected"].items():
        t0 = time.perf_counter()
        got = IO.read_image(path)
        parts["read_image"].append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got, want):
            raise SystemExit(f"{path} did not decode to the array written")
        with open(path, "rb") as f:
            header, _, idat = IO.png_chunks(path, f.read())
        t0 = time.perf_counter()
        raw = IO.inflate(path, idat, header)
        t1 = time.perf_counter()
        rows = IO.unfilter(raw, header.height, header.rowbytes, header.bpp)
        t2 = time.perf_counter()
        parts["inflate"].append((t1 - t0) * 1e3)
        parts["unfilter"].append((t2 - t1) * 1e3)
        if not np.array_equal(rows, IO.unfilter_plain(raw, header.height, header.rowbytes,
                                                     header.bpp)):
            raise SystemExit(f"{path}: the unfilter library differs from its plain version")
    decode_ms = {k: statistics.median(v) for k, v in parts.items()}
    log(f"[files] {len(parts['read_image'])} tiles decoded bit for bit to the arrays written; "
        f"the unfilter library equal to its plain version on each; host ms per tile, median: "
        f"read_image {decode_ms['read_image']:.3f} (range {min(parts['read_image']):.3f}-"
        f"{max(parts['read_image']):.3f}), of which inflate {decode_ms['inflate']:.3f} and "
        f"unfilter {decode_ms['unfilter']:.3f}")

    # records: the planted skips and the container-crane switch
    fcfg = get_cfg()
    fcfg.merge_from_list(DOTA_1024)
    for remove in (True, False):  # registered last with the default, as the CLI registers it
        fcfg.DATASETS.DOTA_REMOVE_CONTAINER_CRANE = remove
        register_all_datasets(fcfg)
        labels = [a["category_id"] for r in get_dataset("dota_1_5_train_1024")
                  for a in r["annotations"]]
        scene, cranes = tree["crane"]
        if len(labels) != scene + (0 if remove else cranes) or labels.count(15) != (
                0 if remove else cranes):
            raise SystemExit(f"DOTA-1.5 container-crane (removed {remove}): {len(labels)} objects")
    counts = {}
    for split in ("train", "val", "test"):
        recs = get_dataset(f"dota_1_{split}_1024")
        with open(os.path.join(data_dir, "dota_1_split", f"{split}1024",
                               f"DOTA1_{split}1024.json")) as f:
            in_json = len(json.load(f).get("annotations", []))
        kept = sum(len(r["annotations"]) for r in recs)
        counts[split] = (kept, in_json - kept)
    if counts != tree["counts"]:
        raise SystemExit(f"records kept / dropped {counts}, planted {tree['counts']}")
    log(f"[files] records (objects kept, dropped) per split {counts}, as planted (area <= 10, "
        f"sides < 2, a degenerate quad, a 6-value polygon); DOTA-1.5 container-cranes kept and "
        f"removed as DATASETS.DOTA_REMOVE_CONTAINER_CRANE says")

    # weights: a Detectron2 .pth of the whole model and an MSRA R-50.pkl
    wmodel = build_model(fcfg, device="cuda", generator=torch.Generator().manual_seed(15))
    values = reference_values(wmodel.state_dict(), np.random.RandomState(16))
    pkl, pth = write_reference_checkpoints(values, os.path.join(files_dir, "weights"))
    report = W.load_reference_weights(pth, wmodel)
    got = {k: v.cpu() for k, v in wmodel.state_dict().items()}
    if report.unfilled or report.unmatched or set(got) != set(values) or not all(
            torch.equal(got[k], torch.from_numpy(v)) for k, v in values.items()):
        raise SystemExit(f"the .pth import: unfilled {report.unfilled[:5]}, unmatched "
                         f"{report.unmatched[:5]}, or a tensor differs from the file")
    wmodel = build_model(fcfg, device="cuda", generator=torch.Generator().manual_seed(17))
    init = {k: v.cpu() for k, v in wmodel.state_dict().items()}
    report = W.load_reference_weights(pkl, wmodel)
    got = {k: v.cpu() for k, v in wmodel.state_dict().items()}
    backbone = {k for k in got if k.startswith("backbone.") and "running_" not in k}
    if report.filled != backbone or report.unmatched or not all(
            torch.equal(got[k], torch.from_numpy(values[k]) if k in backbone else init[k])
            for k in got):
        raise SystemExit("the R-50.pkl import did not fill exactly the backbone")
    log(f"[files] weights: the Detectron2 .pth filled all {len(values)} tensors, each equal to "
        f"the file; the MSRA R-50.pkl filled the backbone's {len(backbone)} (convs, FrozenBN "
        f"scales and biases; the statistics stay mean 0, variance 1) and nothing else")
    del wmodel, init, got, values
    torch.cuda.empty_cache()

    # train from files through the CLI, then evaluate on the val split
    file_args = DOTA_1024 + [
        "INPUT.MIN_SIZE_TEST", str(CANVAS), "TPU.EVAL_BATCH", str(b),
        "TPU.NMS_GROUP_CANDIDATES", str(GROUP_K)]
    train_dir = os.path.join(files_dir, "train")
    A.reset_launch_counts()
    K.reset_launch_counts()
    IO.reset_launch_counts()
    val_stats = {}
    t0 = time.perf_counter()
    results = cli_main(file_args + [
        "MODEL.WEIGHTS", pkl, "DATASETS.TRAIN", "('dota_1_train_1024',)",
        "DATASETS.TEST", "('dota_1_val_1024',)", "SOLVER.MAX_ITER", str(FILE_STEPS),
        "TEST.EVAL_PERIOD", str(FILE_STEPS), "OUTPUT_DIR", train_dir], stats=val_stats)
    cli_s = time.perf_counter() - t0
    files_launches = {"assign_argmin": A.assign_argmin_cuda.launches,
                      "suppression_matrix": K.suppression_bits_cuda.launches,
                      "greedy_keep": K.greedy_keep_bits_cuda.launches}
    unfilter_calls = IO.unfilter.launches
    with open(os.path.join(train_dir, "metrics.json")) as f:
        written = [json.loads(line) for line in f]
    tmodel_ok = os.path.exists(os.path.join(train_dir, "checkpoints",
                                            f"model_{FILE_STEPS:07d}.pth"))
    val_map = results["dota_1_val_1024"].get("mAP")
    task1 = os.path.join(train_dir, "inference", "dota_1_val_1024", "task1")
    n_val_batches = -(-N_FILE_VAL // b)
    if (files_launches["assign_argmin"] != FILE_STEPS
            or files_launches["suppression_matrix"] != n_val_batches
            or files_launches["greedy_keep"] != n_val_batches):
        raise SystemExit(f"train from files: launches {files_launches} for {FILE_STEPS} steps "
                         f"and {n_val_batches} eval batch")
    if not written or not all(np.isfinite(v) for line in written for k, v in line.items()
                              if k.startswith("loss/")):
        raise SystemExit(f"train from files: losses {written}")
    if not tmodel_ok or not isinstance(val_map, float) or not np.isfinite(val_map) or sorted(
            os.listdir(task1)) != sorted(f"Task1_{c}.txt" for c in DOTA_10_CLASSES):
        raise SystemExit(f"train from files: checkpoint {tmodel_ok}, val mAP {val_map}, "
                         f"task1 files {os.listdir(task1) if os.path.isdir(task1) else None}")
    vst = val_stats["dota_1_val_1024"]
    files_img_s = vst["images"] / vst["loop_s"]
    log(f"[files] CLI: MODEL.WEIGHTS R-50.pkl, {FILE_STEPS} steps on dota_1_train_1024 and "
        f"do_test on dota_1_val_1024 in {cli_s:.2f} s wall; launches {files_launches} (K3 once "
        f"per step, K1 and greedy once per eval batch), png_unfilter {unfilter_calls} calls; "
        f"losses at iteration 1: "
        + json.dumps({k: v for k, v in written[0].items() if k.startswith("loss/")})
        + f"; checkpoint model_{FILE_STEPS:07d}.pth; val mAP {val_map:.4f} (random weights); "
        f"eval loop from files {vst['images']} images {vst['loop_s']:.3f} s = {files_img_s:.2f} "
        f"img/s (phase 11, in memory: {phase11_img_s:.2f}) [{card}]")

    # the unlabeled test split: --eval-only from the .pth, merge and zip
    test_dir = os.path.join(files_dir, "test")
    K.reset_launch_counts()
    test_stats = {}
    t0 = time.perf_counter()
    results = cli_main(["--eval-only"] + file_args + [
        "MODEL.WEIGHTS", pth, "DATASETS.TEST", "('dota_1_test_1024',)", "OUTPUT_DIR", test_dir],
        stats=test_stats)
    cli_s = time.perf_counter() - t0
    test_launches = {"suppression_matrix": K.suppression_bits_cuda.launches,
                     "greedy_keep": K.greedy_keep_bits_cuda.launches}
    n_test_batches = -(-8 // b)
    if set(test_launches.values()) != {n_test_batches} or results["dota_1_test_1024"] != {}:
        raise SystemExit(f"test split: launches {test_launches}, results {results}")
    inference = os.path.join(test_dir, "inference", "dota_1_test_1024")
    files = sorted(f"Task1_{c}.txt" for c in DOTA_10_CLASSES)
    with zipfile.ZipFile(os.path.join(inference, "submission.zip")) as z:
        zipped = z.namelist()
    if zipped != files or sorted(os.listdir(os.path.join(inference, "task1"))) != files:
        raise SystemExit(f"test split: zip {zipped}")
    t0 = time.perf_counter()
    n_in = n_out = 0
    for fn in files:  # the merge against poly_nms_plain, image by image and class by class
        with open(os.path.join(inference, "task1", fn)) as f:
            lines = [line.split() for line in f if line.strip()]
        by_image = {}
        for p in lines:
            name, rate, ox, oy = parse_tile_id(p[0])
            poly = (np.asarray([float(v) for v in p[2:10]]).reshape(4, 2) + [ox, oy]).reshape(8)
            by_image.setdefault(name, []).append((float(p[1]), poly / rate))
        want = []
        for name, dets in by_image.items():
            polys = np.stack([d[1] for d in dets])
            scores = np.asarray([d[0] for d in dets])
            for i in np.where(poly_nms_plain(polys, scores, 0.1))[0]:
                want.append(f"{name} {scores[i]:.4f} " + " ".join(f"{v:.2f}" for v in polys[i]))
        with open(os.path.join(inference, "task1_merged", fn)) as f:
            got_lines = f.read().splitlines()
        if got_lines != want or not {g.split()[0] for g in got_lines} <= {"P0001", "P0002"}:
            raise SystemExit(f"test split: {fn} merged differs from poly_nms_plain's")
        n_in, n_out = n_in + len(lines), n_out + len(got_lines)
    plain_s = time.perf_counter() - t0
    tst = test_stats["dota_1_test_1024"]
    log(f"[files] CLI --eval-only from the Detectron2 .pth on dota_1_test_1024 (8 tiles, no "
        f"annotations) in {cli_s:.2f} s wall; launches {test_launches}; task1/, task1_merged/ "
        f"and submission.zip (the 15 Task1 files) written; host s: loop {tst['loop_s']:.3f}, "
        f"Task1 files {tst['task1_s']:.3f}, merge {tst['merge_s']:.3f}, zip {tst['zip_s']:.3f}; "
        f"{n_in} tile detections merged into {n_out} on P0001 and P0002, equal to "
        f"poly_nms_plain's image by image and class by class (checked in {plain_s:.1f} s) "
        f"[{card}]")

    # train step ms from files against the same records with in-memory images
    file_records = get_dataset("dota_1_train_1024", fcfg)
    mem_records = [dict(r, image=IO.read_image(r["file_name"])) for r in file_records]
    abmodel = build_model(train_cfg, device="cuda", generator=torch.Generator().manual_seed(18))
    file_ms = {"files": [], "memory": []}
    for where in ("files", "memory", "memory", "files"):
        c_ = copy.deepcopy(train_cfg)
        c_.SOLVER.MAX_ITER = FILE_AB_STEPS
        c_.OUTPUT_DIR = os.path.join(files_dir, f"ab_{where}")
        torch.cuda.synchronize()
        A.reset_launch_counts()
        t0 = time.perf_counter()
        last = do_train(c_, abmodel, file_records if where == "files" else mem_records)
        torch.cuda.synchronize()
        file_ms[where].append((time.perf_counter() - t0 - last["checkpoint_s"]) * 1e3
                              / FILE_AB_STEPS)
        if A.assign_argmin_cuda.launches != FILE_AB_STEPS or not last["loss_is_finite"]:
            raise SystemExit(f"{where} do_train: K3 {A.assign_argmin_cuda.launches}, {last}")
    map_ms = {}
    with ThreadPoolExecutor(train_cfg.DATALOADER.NUM_WORKERS) as pool:
        for where, recs in (("files", file_records), ("memory", mem_records)):
            ab_loader = DataLoader(train_cfg, recs, b, seed=1, pad_hw=(CANVAS, CANVAS),
                                   pin_memory=True)
            map_ms[where] = host_ms(lambda: ab_loader.make_batch(list(range(b)),
                                                                 list(range(b)), pool))
    log(f"[files] DOTA-1.0 1024 recipe, R-50 full width, batch {b}: step_ms from files "
        f"{[round(v, 2) for v in file_ms['files']]} beside the same records with in-memory "
        f"images {[round(v, 2) for v in file_ms['memory']]} (runs of {FILE_AB_STEPS} steps in the "
        f"order files, memory, memory, files; host clock, synchronised, loader start included, "
        f"checkpoint save excluded); phase 7's in-memory step_ms "
        f"{train_s * 1e3 / TRAIN_STEPS:.2f}; one batch's mapping, map_ms from files "
        f"{map_ms['files']:.2f} against in memory {map_ms['memory']:.2f} ({b} records on "
        f"{train_cfg.DATALOADER.NUM_WORKERS} threads, host clock, median of 3) [{card}]")
    files_launches["suppression_matrix"] += test_launches["suppression_matrix"]
    files_launches["greedy_keep"] += test_launches["greedy_keep"]
    del abmodel, mem_records
    torch.cuda.empty_cache()

    kernels = [
        {"name": "suppression_matrix", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:164",
         "launches": launches["suppression_matrix"] + eval_launches["suppression_matrix"]
         + tta_launches["suppression_matrix"] + files_launches["suppression_matrix"],
         "launches_by_path": {"inference": launches["suppression_matrix"],
                              "eval": eval_launches["suppression_matrix"],
                              "tta": tta_launches["suppression_matrix"],
                              "files": files_launches["suppression_matrix"]},
         "max_abs_err": max_err["suppression_matrix"], "ms": k1_ms, "device_ms": k1_dev,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "greedy_keep", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:312",
         "launches": launches["greedy_keep"] + eval_launches["greedy_keep"]
         + tta_launches["greedy_keep"] + files_launches["greedy_keep"],
         "launches_by_path": {"inference": launches["greedy_keep"],
                              "eval": eval_launches["greedy_keep"],
                              "tta": tta_launches["greedy_keep"],
                              "files": files_launches["greedy_keep"]},
         "max_abs_err": max_err["greedy_keep"], "ms": g_ms, "device_ms": g_dev,
         "plain_ms": g_plain_ms, "bound_ms": g_bound, "bound_by": g_by, "library_ms": None},
        {"name": "assign_argmin", "route": "cuda", "source": "dafne_torch/csrc/assign.cu",
         "replaces": "dafne_tpu/ops/pallas/assign.py:35",
         "launches": train_launches + da_launches + files_launches["assign_argmin"],
         "launches_by_path": {"train": train_launches, "train_device_aug": da_launches,
                              "files": files_launches["assign_argmin"]},
         "max_abs_err": max_err["assign_argmin"], "ms": k3_ms, "device_ms": k3_dev,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "suppression_matrix_2d", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:128", "launches": k2_launches,
         "max_abs_err": max_err["suppression_matrix_2d"], "ms": k2_ms, "device_ms": k2_dev,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
