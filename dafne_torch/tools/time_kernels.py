"""Time the port's hand-written kernels on one GPU, for A/B between checkouts:
the 2-D tiled suppression kernel (K2), the assignment kernel (K3), the int8
conv (``int8_conv``) and the deformable sampler's forward
(``deform_im2col``).

    python3 dafne_torch/tools/time_kernels.py [--root DIR] [--reps 50]
                                              [--kernels k2,k3,int8_conv,deform_im2col]

K2 runs on two inputs: the dense score-ordered mix of chip_smoke.py phase 10
(B = 8, N = 4096, 15 classes interleaved, every slot valid) and the grouped
NMS input of one eval batch ([B * G, K] = [112, 512], from the DOTA-1.0 1024
inference model at full width with seeded random weights and the class
bias at -2 on 8 synthetic 1024^2 scenes, as dafne_torch/tools/time_decode.py
builds it).  K3 runs on the three mixes of chip_smoke.py phase 6 (B = 8,
K = 21 824 locations of a 1024^2 canvas, M = 256 slots): the packed gts of
synthetic train scenes, 256 valid random gts, and 128 gts duplicated.
``int8_conv`` runs at the P3 tower 3x3 and the largest res4 1x1 site of
chip_smoke.py phase 22's dynamic-scale eval step (the DOTA-1.0 1024 recipe
from its seed, class bias -2, its last batch of 8 test scenes), each
site's own input quantized by ``quantize_act``; beside it ``torch._int_mm``
on the same [M, C] x [C, O] matrix (1x1) or on a precomputed NHWC column
matrix [M, 9C] x [9C, O] (3x3): the GEMM alone, which the port never
calls.  ``deform_im2col`` runs at P3 in bf16 ([8, 256, 128, 128], offsets
in +-4 px, no mask, as phase 20 draws them), beside ``F.grid_sample`` over
the 9 taps (a time yardstick only: its grid is bf16).
For each: CUDA events around each call of the wrapper (median, 10th and
90th percentile of --reps calls; the wrapper's host time is inside when
the card waits for the launch), the kernels' own device time and the
device time of every kernel of the call (a fill, say) from a
torch.profiler trace, and whether the result equals the plain version
(K2: the bit rows equal the packed plain S, or int8 S equal to it; K3:
min_area bit-equal and argmin equal; int8_conv and deform_im2col: bit for
bit, the sampler with and without a mask).  K2 lines also give K1's device time
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


def int8_sites(smoke):
    """{"P3": (x, module), "res4_1x1": (x, module)}: phase 22's timed sites
    of the dynamic-scale eval step, their inputs recorded in one forward."""
    import numpy as np
    import torch

    from dafne_torch.config import get_cfg
    from dafne_torch.data.synthetic import load_synthetic_gen
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.models import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, smoke.EXPORT_RECIPE))
    cfg.merge_from_list(["TPU.EVAL_BATCH", str(BATCH), "TPU.EVAL_INT8", "True"])
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(smoke.INT8_SEED))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    model.eval()
    scenes = [r["image"] for r in load_synthetic_gen(
        "test", (smoke.INT8_CALIB_BATCHES + 1) * BATCH, hw=CANVAS, max_boxes=96)]
    images = torch.from_numpy(np.stack(scenes[-BATCH:])).cuda()
    sites, _ = smoke.int8_site_inputs(make_eval_step(model, cfg, (CANVAS, CANVAS)), images)
    p3 = max((v[:2] for k, v in sites.items() if k[3] == (3, 3)), key=lambda v: v[0].numel())
    res4 = max((v[:2] for k, v in sites.items()
                if k[3] == (1, 1) and k[4] == (1, 1) and k[0][2] == CANVAS // 16),
               key=lambda v: v[0].numel())
    return {"P3": p3, "res4_1x1": res4}


def time_int8_conv(smoke, reps):
    import torch
    import torch.nn.functional as F

    from dafne_torch.ops.kernels import quant as QK
    from dafne_torch.utils.measure import device_ms

    out = {}
    with torch.inference_mode():
        for site, (x, mod) in int8_sites(smoke).items():
            scale, conv_args = smoke.int8_site_args(x, mod)
            wq, _, _, stride, padding, dilation, _ = conv_args
            xq, xs = QK.quantize_act_cuda(x, scale)
            n, h, w, c = xq.shape
            o, kh, kw = wq.shape[:3]
            ho, wo = QK.conv_out_hw(h, w, kh, kw, stride, padding, dilation)
            fn = lambda: QK.int8_conv_cuda(xq, xs, *conv_args)  # noqa: E731
            if (kh, kw) == (1, 1):
                a2 = xq.reshape(n * h * w, c)
            else:  # the NHWC column matrix, tap-major as w_q
                pad = F.pad(xq, (0, 0, padding[1], padding[1], padding[0], padding[0]))
                a2 = torch.cat([pad[:, r:r + ho, q:q + wo] for r in range(kh)
                                for q in range(kw)], -1).reshape(n * ho * wo, kh * kw * c)
                del pad
            b2 = wq.reshape(o, kh * kw * c).t()
            out[site] = {"x": list(x.shape), "out_channels": o, "kernel": [kh, kw],
                         "stride": list(stride), "dtype": str(x.dtype)[6:],
                         "path": (QK.int8_conv_path(c, stride)
                                  if hasattr(QK, "int8_conv_path") else "mma_sync"),
                         "equal_to_plain": bool(torch.equal(fn(),
                                                            QK.int8_conv_plain(xq, xs, *conv_args))),
                         **event_stats(fn, reps),
                         "device_ms": device_ms(fn, "int8_conv"),
                         "device_busy_ms": device_ms(fn, "", launches=None),
                         "int_mm_ms": event_stats(lambda: torch._int_mm(a2, b2), reps)["median_ms"]}
            del a2, b2
            torch.cuda.empty_cache()
    return out


def time_deform(smoke, reps):
    import torch
    import torch.nn.functional as F

    from dafne_torch.layers.deform_conv import deform_im2col_plain
    from dafne_torch.ops.kernels import deform_conv as DK
    from dafne_torch.utils.measure import device_ms

    c, h, w = smoke.DEFORM_SHAPES["P3"]
    gen = torch.Generator(device="cuda").manual_seed(20)
    x, off, mask = smoke.deform_inputs(c, h, w, torch.bfloat16, gen)
    fn = lambda: DK.deform_im2col_forward_cuda(x, off)  # noqa: E731
    equal = all(torch.equal(DK.deform_im2col_forward_cuda(x, off, m), deform_im2col_plain(x, off, m))
                for m in (None, mask))
    grid = smoke.grid_sample_grid(off, h, w).to(x.dtype)
    kernels = getattr(DK, "FORWARD_KERNELS", ("deform_im2col_kernel",))
    return {"P3": {"x": [BATCH, c, h, w], "dtype": "bfloat16", "kernels": list(kernels),
                   "equal_to_plain": bool(equal), **event_stats(fn, reps),
                   "device_ms": device_ms(fn, "deform_im2col", launches=len(kernels)),
                   "device_busy_ms": device_ms(fn, "", launches=None),
                   "grid_sample_ms": event_stats(lambda: F.grid_sample(
                       x, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
                       reps)["median_ms"]}}


KERNELS = ("k2", "k3", "int8_conv", "deform_im2col")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose dafne_torch is timed")
    ap.add_argument("--reps", type=int, default=50, help="timed calls per input")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated subset of {','.join(KERNELS)}")
    args = ap.parse_args(argv)
    which = args.kernels.split(",")
    if not set(which) <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(set(which) - set(KERNELS))}")
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
    out = {"root": os.path.abspath(args.root), "card": card, "reps": args.reps}
    if "k2" in which:
        dense = smoke.class_major_mix(np.random.RandomState(0), BATCH, 4096, 4096,
                                      class_major=False)
        inputs = {"dense-15cls-score-order": (*dense, 0.1), "grouped-eval": grouped_input(cfg_mod)}
        out["k2"] = time_k2(smoke, inputs, args.reps)
    if "k3" in which:
        out["k3"] = time_k3(smoke, args.reps)
    if "int8_conv" in which:
        out["int8_conv"] = time_int8_conv(smoke, args.reps)
    if "deform_im2col" in which:
        out["deform_im2col"] = time_deform(smoke, args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
