#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's failure is caught):
  1. the card, and an nvcc build of dafne_torch/csrc/*.cu for sm_90a;
  2. the suppression-matrix kernel against its plain PyTorch version at
     N = 4096, batch 8, on a dense all-valid 15-class mix and a 25%-valid
     class-major mix: S must be equal entry for entry;
  3. the greedy keep kernel against the plain sequential walk on those S
     and on one with a 300-box suppression chain: equal keep-sets;
  4. the main path: R-50 + FPN P3-P7 + DAFNe head at full width, 15 classes,
     a 1024x1024 canvas, bf16, batch 8, seeded random weights (cls bias -2 so
     that the 4096-slot NMS input is filled), after one warm-up batch
     WINDOWS windows of WINDOW_BATCHES batches of synthetic-scene requests
     through engine/predictor.py; both kernels must have launched in them;
     then one batch's wall time split on the host clock (canvas, copy to
     the card, eval step, the rest) and the device phases on CUDA events;
  5. the kernels against their plain versions on the main path's own NMS
     inputs, with times and bounds; and a small float32 reference check:
     the same narrow model on the card and on the CPU (plain versions) must
     give the same detections.

The line before the last holds one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Every time printed is
measured in this run, on the card named by the nvidia-smi line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

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

BATCH = 8  # main-path batch, and the batch of the kernel checks
N_NMS = 4096  # TPU.NMS_MAX_CANDIDATES: the NMS size of the main path
CANVAS = 1024  # the DOTA-1.0 1024 recipe's test canvas
N_SCENES = 16  # distinct synthetic requests, sent round-robin
WINDOWS, WINDOW_BATCHES = 3, 10  # timed windows of the main path


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


def class_major_mix(rng, b, n, n_valid, n_classes=15):
    """Kernel inputs in the order NMS gives them: ascending class, invalid
    (-1) last, corners CCW.  The valid boxes are jittered copies of n/8
    cluster seeds and share their seed's class, so S has many nonzeros and
    IoUs near the threshold."""
    from dafne_torch.ops.nms import _as_ccw_rows

    seeds = random_quads(rng, b, max(n // 8, 1))
    seed_cls = rng.randint(0, n_classes, seeds.shape[:2])
    pick = rng.randint(0, seeds.shape[1], (b, n_valid))
    quads = random_quads(rng, b, n)
    quads[:, :n_valid] = np.take_along_axis(seeds, pick[..., None], 1) + rng.uniform(
        -8, 8, (b, n_valid, 8)).astype(np.float32)
    classes = np.full((b, n), -1, np.int32)
    classes[:, :n_valid] = np.take_along_axis(seed_cls, pick, 1)
    order = np.argsort(np.where(classes < 0, n_classes, classes), axis=1, kind="stable")
    quads = np.take_along_axis(quads, order[..., None], 1)
    classes = np.take_along_axis(classes, order, 1)
    corners = _as_ccw_rows(torch.from_numpy(quads)).cuda().contiguous()
    return corners, torch.from_numpy(classes).cuda()


def suppression_bound(classes, n):
    """((bound ms, bound_by), same-class pairs, ops bound ms without FMA):
    the larger of the f32 work these inputs need (OPS_PER_PAIR for every
    same-class pair j > i) over F32_FLOPS and the bytes (corners and
    classes read once, S written once) over the card's memory rate.  The
    last item is the work over F32_OPS_NO_FMA, the rate the kernel as
    built can reach."""
    from dafne_torch.ops.kernels.quad_nms import OPS_PER_PAIR

    cls = classes.cpu().numpy()
    pairs = 0
    for row in cls:
        counts = np.bincount(row[row >= 0])
        pairs += int((counts * (counts - 1) // 2).sum())
    b = cls.shape[0]
    t_ops = pairs * OPS_PER_PAIR / F32_FLOPS * 1e3
    t_bytes = b * (n * 8 * 4 + n * 4 + n * n) / HBM_BYTES_PER_S * 1e3
    bound = (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
    return bound, pairs, pairs * OPS_PER_PAIR / F32_OPS_NO_FMA * 1e3


def greedy_bound(keep, n):
    """Bytes the walk needs: each kept row's upper triangle of S, plus the
    keep_init read and the keep written; no arithmetic to speak of."""
    idx = torch.nonzero(keep)[:, 1].cpu().numpy()
    nbytes = int((n - 1 - idx).sum()) + 2 * keep.numel()
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dafne_torch.config import get_cfg
    from dafne_torch.data.synthetic import load_synthetic_gen
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.engine.predictor import Predictor
    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import build as kbuild
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.nms import sorted_nms_inputs
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
    build_log = kbuild.build("quad_nms")
    log(f"[build] nvcc sm_90a quad_nms.cu: {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    rng = np.random.RandomState(0)
    b, n = BATCH, N_NMS
    max_err = {"suppression_matrix": 0.0, "greedy_keep": 0.0}

    # ---- 2. suppression kernel vs plain ------------------------------------
    s_by_mix = {}
    for mix, n_valid in (("dense-15cls", n), ("25pct-valid", n // 4)):
        corners, classes = class_major_mix(rng, b, n, n_valid)
        s_kernel = K.suppression_matrix_cuda(corners, classes, 0.1)
        s_plain = K.suppression_matrix_plain(corners, classes, 0.1)
        torch.cuda.synchronize()
        diff = int((s_kernel != s_plain).sum())
        max_err["suppression_matrix"] = max(max_err["suppression_matrix"], float(diff > 0))
        ms = cuda_ms(lambda: K.suppression_matrix_cuda(corners, classes, 0.1))
        plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(corners, classes, 0.1), reps=3, warmup=1)
        (bound, by), pairs, no_fma = suppression_bound(classes, n)
        log(f"[K1 {mix}] B={b} N={n} nonzeros={int(s_kernel.sum())} differing_entries={diff} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={bound:.4f} ({by}; "
            f"same-class pairs {pairs}, {K.OPS_PER_PAIR} f32 ops each; S bytes {b * n * n}) "
            f"ops_bound_no_fma_ms={no_fma:.4f} [{card}]")
        if diff:
            raise SystemExit(f"suppression kernel disagrees with its plain version on {mix}")
        s_by_mix[mix] = (s_kernel, classes >= 0)

    # ---- 3. greedy kernel vs plain walk ------------------------------------
    chain = torch.from_numpy(np.triu(rng.uniform(size=(n, n)) < 0.002, 1).astype(np.int8))
    links = torch.arange(min(300, n - 1))
    chain[links, links + 1] = 1
    s_by_mix["chain-300"] = (chain[None].cuda().contiguous(),
                             torch.from_numpy(rng.uniform(size=(1, n)) > 0.05).cuda())
    for mix, (s, keep_init) in s_by_mix.items():
        k_kernel = K.greedy_keep_cuda(s, keep_init)
        k_plain = K.greedy_keep_plain(s, keep_init)
        torch.cuda.synchronize()
        diff = int((k_kernel != k_plain).sum())
        max_err["greedy_keep"] = max(max_err["greedy_keep"], float(diff > 0))
        ms = cuda_ms(lambda: K.greedy_keep_cuda(s, keep_init))
        plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s, keep_init), reps=3, warmup=1)
        bound, by = greedy_bound(k_kernel, n)
        log(f"[greedy {mix}] B={s.shape[0]} N={n} kept={int(k_kernel.sum())} differing={diff} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={bound:.5f} ({by}) [{card}]")
        if diff:
            raise SystemExit(f"greedy kernel disagrees with the plain walk on {mix}")
    del s_by_mix, chain

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
    launches = {"suppression_matrix": K.suppression_matrix_cuda.launches,
                "greedy_keep": K.greedy_keep_cuda.launches}
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
        k1_ms = cuda_ms(lambda: K.suppression_matrix_cuda(pc, pk, spec.nms_threshold))
        s_main = K.suppression_matrix_cuda(pc, pk, spec.nms_threshold)
        s_plain = K.suppression_matrix_plain(pc, pk, spec.nms_threshold)
        k1_plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(pc, pk, spec.nms_threshold),
                              reps=3, warmup=1)
        g_ms = cuda_ms(lambda: K.greedy_keep_cuda(s_main, pv))
        keep_main = K.greedy_keep_cuda(s_main, pv)
        keep_plain = K.greedy_keep_plain(s_main, pv)
        g_plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s_main, pv), reps=3, warmup=1)
    d1 = int((s_main != s_plain).sum())
    d2 = int((keep_main != keep_plain).sum())
    max_err["suppression_matrix"] = max(max_err["suppression_matrix"], float(d1 > 0))
    max_err["greedy_keep"] = max(max_err["greedy_keep"], float(d2 > 0))
    if d1 or d2:
        raise SystemExit(f"kernels disagree on the main path's inputs: S {d1}, keep {d2}")
    (k1_bound, k1_by), pairs, k1_no_fma = suppression_bound(pk, pk.shape[1])
    g_bound, g_by = greedy_bound(keep_main, pk.shape[1])
    n_img = WINDOWS * len(requests)
    log(f"[main] R-50 DOTA {CANVAS}x{CANVAS} bf16 batch {b}: {n_img / sum(windows_s):.2f} img/s "
        f"({n_img} requests in {WINDOWS} windows of {WINDOW_BATCHES} batches, "
        f"{sum(windows_s) * 1e3:.1f} ms wall, host included; window seconds "
        f"{windows_s}) [{card}]")
    log(f"[main] per batch of {b}: model_ms={model_ms:.3f} decode_ms={decode_ms:.3f} "
        f"(of which K1_ms={k1_ms:.4f} greedy_ms={g_ms:.4f}); NMS N={pk.shape[1]}, "
        f"same-class pairs {pairs}, kept {int(keep_main.sum())}; K1 bound_ms={k1_bound:.4f} "
        f"({k1_by}, {K.OPS_PER_PAIR} ops per pair at {F32_FLOPS / 1e12:.0f} TFLOP/s), "
        f"ops_bound_no_fma_ms={k1_no_fma:.4f} (at {F32_OPS_NO_FMA / 1e12:.1f} T ops/s) [{card}]")

    # ---- 5. small float32 reference: card (kernels) vs CPU (plain) ---------
    small = get_cfg()
    small.merge_from_list([
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.FPN.OUT_CHANNELS", "32",
        "TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_MAX_CANDIDATES", "1024",
        "MODEL.DAFNE.POST_NMS_TOPK_TEST", "300",
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

    kernels = [
        {"name": "suppression_matrix", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:164",
         "launches": launches["suppression_matrix"],
         "max_abs_err": max_err["suppression_matrix"], "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "greedy_keep", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:312",
         "launches": launches["greedy_keep"],
         "max_abs_err": max_err["greedy_keep"], "ms": g_ms, "plain_ms": g_plain_ms,
         "bound_ms": g_bound, "bound_by": g_by, "library_ms": None},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
