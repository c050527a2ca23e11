"""Attribute the train step's and the eval step's time on the card, phase by phase.

    python -m dafne_torch.tools.train_step_profile [--phases model_fwd,loss_fwd,train_step]
        [--out PROFILE_TRAIN_TORCH.json] [--iters 10] [--warmup 2] [--batch 8] [--hw 1024]
        [--cpu] [KEY VALUE ...]

Counterpart of ``tools/train_step_profile.py``: the flagship model (R-50,
15 classes, bf16 compute, the config's defaults; trailing KEY VALUE pairs
override it) with seeded random weights on a synthetic batch (the JAX
tool's generator: BATCH images of HW^2 random pixels, 24 rotated gts
each), one program per phase, each timed with CUDA events around ITERS
calls after WARMUP calls (the host clock on the CPU):

  model_fwd        backbone + FPN + head forward, every head output consumed
  loss_fwd         + assignment + losses, no gradient
  assign_only      the target assignment alone (the assignment kernel, K3)
  losses_only      the losses on captured head outputs; losses_grad: + their gradient
  model_grad       forward + backward of the model under a trivial loss
  eval_full        the eval step: forward, decode and rotated NMS (K1, greedy)
  eval_int8        the eval step with TPU.EVAL_INT8 at each width, dynamic and static
                   (scales calibrated on the batch, min_channels 64), beside bf16
  model_fwd_int8   the forward with its convs in int8 at widths 64, 128, 256
  nms_only         rotated NMS on 4096 clustered candidates (K1 + greedy)
  suppression_only, suppression_only_2d   the suppression matrix alone (K1, K2)
  greedy_only      the greedy walk alone over K1's bit rows
  decode_only      decode on captured head outputs (CUDA events and the host clock:
                   the decode syncs with the host); decode_no_sort: without the corner sort
  train_step       the full train step (forward, assignment, losses, backward, SGD)
  train_step_xla_assign   the same with TPU.ASSIGN_IMPL xla: the assignment's plain version
  eval_roofline    eval_full split by program differencing (the skip_nms diagnostic,
                   ``make_eval_step(decode_overrides=)``) into model_fwd, decode_topk, nms
  roofline         model_fwd, model_grad, eval_full, train_step against their bounds
  tta_r101         TTA of configs/pre-trained/dota-1.0_r101_ms.yaml on one 1024^2 image

Refused by name: ``train_step_remat`` (TPU.REMAT_BACKBONE, a TPU-only key
the port does not read), ``train_step_host_assign`` (TPU.HOST_ASSIGN raises
in the port) and ``decode_exact`` (the port has only the exact top-k:
decode_only is it).

Bounds (``roofline``, ``eval_roofline``): a program's FLOPs are
FlopCounterMode's (convolutions and matrix products, a multiply-add as 2,
the backward included) at the card's bf16 peak; the ``dafne::`` kernels'
own operation counts (K1's IoU pairs, ``ops/kernels/quad_nms.py``) and the
assignment kernel's (``ops/kernels/assign.py::pair_counts``) at the float32
rate without FMA; and its bytes (its inputs read once, the model's state
read once, its outputs written once; a train step also writes its
parameters and reads and writes the optimizer's state) at the HBM rate.
The bound is the largest of the three, and each row names it.  ``mfu`` is
a program's FLOPs over its time at the bf16 peak (``utils/measure.py``),
"not measured" off the card.

Times are taken under the CLI's cuDNN settings (benchmark off,
``canary.cli_backend_flags``), printed and recorded.  Writes the
record (each phase's ms, the launches of each kernel per phase, the card's
name and power limit) merged into ``--out`` (default
PROFILE_TRAIN_TORCH.json at the repo root; JAX's PROFILE_TRAIN.json is
never written); a batch other than 8 (``--batch``, where JAX's reads
PROFILE_BATCH) suffixes every key with ``_b<N>`` as JAX's does.  Prints
one line per phase and the record as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "PROFILE_TRAIN_TORCH.json")
BATCH = 8
HW = 1024
ITERS, WARMUP = 10, 2
N_GT = 24  # gts per image of the synthetic batch
PHASES = ("model_fwd", "loss_fwd", "assign_only", "losses_only", "losses_grad", "model_grad",
          "eval_full", "eval_int8", "model_fwd_int8", "nms_only", "suppression_only",
          "suppression_only_2d", "greedy_only", "decode_only", "decode_no_sort", "train_step",
          "train_step_xla_assign", "eval_roofline", "roofline", "tta_r101")
REFUSED = {
    "train_step_remat": "TPU.REMAT_BACKBONE is a key of the JAX package's TPU namespace "
                        "(jax.checkpoint over the backbone stages) that the port does not read",
    "train_step_host_assign": "TPU.HOST_ASSIGN=True is not ported: engine/trainer.py raises",
    "decode_exact": "the port has only the exact top-k (TPU.DECODE_APPROX_TOPK raises), so "
                    "decode_only is the exact decode",
}
TRIV_KEYS = ("logits", "corners", "ctrness")  # model_grad's trivial loss (JAX :281-287)


def check_phases(phases) -> None:
    """Raise SystemExit on a refused or unknown phase, naming it."""
    for p in phases:
        if p in REFUSED:
            raise SystemExit(f"phase {p} refused: {REFUSED[p]}")
        if p not in PHASES:
            raise SystemExit(f"unknown phase {p!r}; phases: {', '.join(PHASES)}")


def flagship_cfg(opts=(), **tpu_overrides):
    """The JAX tool's flagship config (:38-47) and then `opts`."""
    from dafne_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.DAFNE.NUM_CLASSES = 15
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    for k, v in tpu_overrides.items():
        setattr(cfg.TPU, k, v)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def synthetic_batch(rng, batch: int, hw: int, device, n_gt: int = N_GT) -> Dict[str, torch.Tensor]:
    """The JAX tool's synthetic batch (:50-77), drawn in the same order from
    `rng`: random pixels and `n_gt` rotated rectangles per image."""
    quads = []
    for _ in range(batch * n_gt):
        cx, cy = rng.uniform(100, hw - 100, 2)
        w, h = rng.uniform(16, 120, 2)
        th = rng.uniform(0, np.pi)
        c, s = np.cos(th), np.sin(th)
        dx = np.array([-w, w, w, -w]) / 2
        dy = np.array([-h, -h, h, h]) / 2
        quads.append(np.stack([cx + dx * c - dy * s, cy + dx * s + dy * c], 1).reshape(8))
    quads = np.asarray(quads, np.float32).reshape(batch, n_gt, 8)
    xs, ys = quads[..., 0::2], quads[..., 1::2]
    hbox = np.stack([xs.min(-1), ys.min(-1), xs.max(-1), ys.max(-1)], -1)
    area = np.abs(0.5 * ((xs * np.roll(ys, -1, -1)).sum(-1) - (ys * np.roll(xs, -1, -1)).sum(-1)))
    out = {"image": rng.rand(batch, hw, hw, 3).astype(np.float32) * 255,
           "gt_corners": quads, "gt_hbox": hbox.astype(np.float32),
           "gt_classes": rng.randint(0, 15, (batch, n_gt)).astype(np.int32),
           "gt_area": area.astype(np.float32), "gt_valid": np.ones((batch, n_gt), bool)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def nms_input(rng, batch: int, hw: int, m: int, device):
    """The JAX tool's realistic NMS input (:396-433): m // 16 clusters of 16
    jittered copies per image, random scores and classes, every slot
    valid; and the same sorted class-major, score-descending within a
    class, CCW (the suppression kernels' precondition)."""
    from dafne_torch.ops.nms import _as_ccw_rows

    n_obj = m // 16
    cx, cy = rng.uniform(100, hw - 100, (2, batch, n_obj, 1))
    w_, h_ = rng.uniform(16, 120, (2, batch, n_obj, 1))
    th = rng.uniform(0, np.pi, (batch, n_obj, 1))
    cx = cx + rng.randn(batch, n_obj, 16) * 4
    cy = cy + rng.randn(batch, n_obj, 16) * 4
    dxs = np.stack([-w_, w_, w_, -w_], -1) / 2 + 0 * th[..., None]
    dys = np.stack([-h_, -h_, h_, h_], -1) / 2 + 0 * th[..., None]
    cth, sth = np.cos(th)[..., None], np.sin(th)[..., None]
    quads = np.stack([cx[..., None] + dxs * cth - dys * sth,
                      cy[..., None] + dxs * sth + dys * cth], -1).reshape(batch, m, 8)
    quads = quads.astype(np.float32)
    scores = rng.rand(batch, m).astype(np.float32)
    classes = rng.randint(0, 15, (batch, m)).astype(np.int32)
    order = np.lexsort((-scores, classes), axis=-1)
    sorted_corners = _as_ccw_rows(torch.from_numpy(np.take_along_axis(quads, order[:, :, None], 1)))
    t = {"corners": torch.from_numpy(quads), "scores": torch.from_numpy(scores),
         "classes": torch.from_numpy(classes), "valid": torch.ones((batch, m), dtype=torch.bool),
         "sorted_corners": sorted_corners.contiguous(),
         "sorted_classes": torch.from_numpy(np.take_along_axis(classes, order, 1))}
    return {k: v.to(device) for k, v in t.items()}


def consume_all(out) -> torch.Tensor:
    """Every head output summed into one scalar (the JAX tool's note at
    :136-145: a forward timed on part of its outputs measures part of the
    model where the compiler drops the rest)."""
    tot = sum(o.float().sum() for k in ("logits", "corners", "ctrness") for o in out[k])
    return tot + sum(o.float().sum() for o in out["center"] if o is not None)


def launch_counts() -> Dict[str, int]:
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.kernels import quad_nms as K

    return {"suppression_matrix": K.suppression_bits_cuda.launches,
            "suppression_matrix_2d": K.suppression_bits_2d_cuda.launches,
            "greedy_keep": K.greedy_keep_bits_cuda.launches,
            "assign_argmin": A.assign_argmin_cuda.launches}


def roofline_row(work: dict, nbytes: int, measured_ms: Optional[float]) -> dict:
    """The bound of a program of `work` (``analyze_model.count_work``) and
    `nbytes`: tensor-core FLOPs at the bf16 peak, the kernels' own f32
    operations at the float32 rate without FMA (int8 ones at the int8
    peak), bytes at the HBM rate; the largest names the row."""
    from dafne_torch.utils.measure import (BF16_FLOPS, F32_OPS_NO_FMA, HBM_BYTES_PER_S,
                                           INT8_OPS_PER_S)

    f32 = sum(k["f32_ops"] for k in work["kernels"].values())
    int8 = sum(k["int8_ops"] for k in work["kernels"].values())
    terms = {"flops": work["flops"] / BF16_FLOPS * 1e3,
             "kernel_ops": f32 / F32_OPS_NO_FMA * 1e3 + int8 / INT8_OPS_PER_S * 1e3,
             "bandwidth": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(terms, key=terms.get)
    return {"flops_g": work["flops"] / 1e9, "kernel_ops_g": (f32 + int8) / 1e9,
            "bytes_gb": nbytes / 1e9, "flops_bound_ms": terms["flops"],
            "kernel_ops_bound_ms": terms["kernel_ops"],
            "compute_bound_ms": max(terms["flops"], terms["kernel_ops"]),
            "bw_bound_ms": terms["bandwidth"],
            "bound_ms": terms[by], "bound": by, "measured_ms": measured_ms,
            "pct_of_bound": (terms[by] / measured_ms if measured_ms and measured_ms > 0
                             else None)}


def mfu(flops: int, ms: float, device: str):
    """FLOPs over the time at the card's bf16 peak; "not measured" off the card."""
    from dafne_torch.utils.measure import BF16_FLOPS

    if device != "cuda":
        return "not measured"
    return flops / (ms * 1e-3) / BF16_FLOPS


class Profile:
    """One run: the flagship model, the batch, the timer and the record."""

    def __init__(self, device: str, opts=(), batch: int = BATCH, hw: int = HW,
                 iters: int = ITERS, warmup: int = WARMUP, seed: int = 0):
        self.device, self.opts, self.batch, self.hw = device, tuple(opts), batch, hw
        self.iters, self.warmup, self.seed = iters, warmup, seed
        self.rng = np.random.RandomState(0)
        self.b = synthetic_batch(self.rng, batch, hw, device)
        self.cfg = flagship_cfg(self.opts)
        self._model = None
        self.results: Dict[str, object] = {"batch": batch, "hw": hw}
        self.work: Dict[str, dict] = {}  # program -> count_work, for the bounds
        self.nbytes: Dict[str, int] = {}

    @property
    def model(self):
        """The flagship model, built on first use (outside inference mode,
        whatever the caller's: its tensors also serve autograd)."""
        from dafne_torch.tools.analyze_model import build

        if self._model is None:
            with torch.inference_mode(False):
                self._model = build(self.cfg, self.device, self.seed)
        return self._model

    # -- timing --------------------------------------------------------------
    def ms(self, fn: Callable[[], object]) -> float:
        """Mean ms per call of fn() over `iters` calls after `warmup`: CUDA
        events on the card, the host clock on the CPU."""
        from dafne_torch.utils.measure import events_ms

        if self.device == "cuda":
            return events_ms(fn, self.iters, self.warmup)
        for _ in range(self.warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
        return (time.perf_counter() - t0) / self.iters * 1e3

    def host_ms(self, fn: Callable[[], object]) -> float:
        """Mean host-clock ms per call over `iters` calls, synchronised at both ends."""
        sync = torch.cuda.synchronize if self.device == "cuda" else (lambda: None)
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / self.iters * 1e3

    def put(self, key: str, value) -> None:
        self.results[key] = value
        print(key, value, flush=True)

    # -- shared pieces -------------------------------------------------------
    def specs(self):
        from dafne_torch.engine.trainer import make_location_tables
        from dafne_torch.ops.losses import LossSpec
        from dafne_torch.ops.targets import AssignmentSpec

        aspec = AssignmentSpec.from_config(self.cfg)
        tables = make_location_tables((self.hw, self.hw), aspec, device=self.device)
        return aspec, LossSpec.from_config(self.cfg), tables

    def head(self):
        with torch.inference_mode():
            out = self.model(self.b["image"])
        return {k: v for k, v in out.items() if k != "hw"}

    def eval_step(self, **overrides):
        from dafne_torch.engine.inference import make_eval_step

        return make_eval_step(self.model, self.cfg, (self.hw, self.hw),
                              decode_overrides=overrides or None)

    def train_step(self, cfg):
        """(step, model, optimizer) of a fresh model of `cfg`, in train mode."""
        from dafne_torch.engine.optimizer import build_optimizer
        from dafne_torch.engine.trainer import make_train_step
        from dafne_torch.tools.analyze_model import build

        model = build(cfg, self.device, self.seed)
        optimizer, scheduler = build_optimizer(cfg, model)
        model.train()
        return make_train_step(model, cfg, (self.hw, self.hw), optimizer, scheduler), model, \
            optimizer

    def assign_work(self, aspec, tables) -> dict:
        """K3's count for one batch (a direct ctypes call: FlopCounterMode
        does not see it): its candidate pairs' f32 operations and its bytes."""
        from dafne_torch.ops.kernels import assign as A

        _, locations, loc_strides, size_ranges = tables
        pairs = A.pair_counts(locations, loc_strides, size_ranges, self.b["gt_hbox"],
                              self.b["gt_valid"], aspec)
        b, m = self.b["gt_valid"].shape
        return {"calls": 1, "f32_ops": pairs["candidate"] * A.OPS_PER_PAIR, "int8_ops": 0,
                "bytes": A.assign_bytes(locations.shape[0], b, m), "pairs": pairs}

    # -- programs with their work ---------------------------------------------
    def fwd_program(self):
        from dafne_torch.tools.analyze_model import count_work, program_bytes

        if "model_fwd" not in self.work:
            with torch.inference_mode():
                self.work["model_fwd"], out = count_work(lambda: self.model(self.b["image"]))
            self.nbytes["model_fwd"] = program_bytes(
                self.b["image"], self.model, {k: v for k, v in out.items() if k != "hw"})

        def run():
            with torch.inference_mode():
                return consume_all(self.model(self.b["image"]))
        return run

    def grad_program(self):
        from dafne_torch.tools.analyze_model import count_work, program_bytes

        params = [p for p in self.model.parameters() if p.requires_grad]

        def run():
            out = self.model(self.b["image"])
            loss = sum(o.float().sum() for k in TRIV_KEYS for o in out[k])
            grads = torch.autograd.grad(loss, params)
            return loss.detach() + sum(g.float().sum() for g in grads)

        if "model_grad" not in self.work:
            self.work["model_grad"], _ = count_work(run)
            self.nbytes["model_grad"] = (program_bytes(self.b["image"], self.model, ())
                                         + sum(p.numel() * 4 for p in params))
        return run

    def eval_program(self, name="eval_full", **overrides):
        from dafne_torch.tools.analyze_model import count_work, program_bytes

        step = self.eval_step(**overrides)

        def run():
            d = step(self.b["image"])
            return d["scores"].sum() + d["corners"].sum()

        if name not in self.work:
            self.work[name], out = count_work(lambda: step(self.b["image"]))
            self.nbytes[name] = program_bytes(self.b["image"], self.model, out)
        return run

    def step_program(self, name="train_step", **tpu_overrides):
        from dafne_torch.tools.analyze_model import count_work, program_bytes

        cfg = flagship_cfg(self.opts, **tpu_overrides)
        step, model, optimizer = self.train_step(cfg)
        step(self.b)  # the optimizer's state exists from here
        if name not in self.work:
            work, _ = count_work(lambda: step(self.b))
            aspec, _, tables = self.specs()
            work["kernels"]["assign_argmin"] = self.assign_work(aspec, tables)
            self.work[name] = work
            self.nbytes[name] = program_bytes(self.b, model, (), train_optimizer=optimizer)
        return lambda: step(self.b)["loss/total"]


# ---- the phases ---------------------------------------------------------------


def phase_model_fwd(P):
    P.put("model_fwd_ms", P.ms(P.fwd_program()))


def phase_loss_fwd(P):
    from dafne_torch.engine.trainer import compute_losses

    aspec, lspec, tables = P.specs()

    def run():
        with torch.no_grad():
            losses, _ = compute_losses(P.model, P.b, aspec, lspec, tables, train=True)
        return losses["loss/total"]

    P.put("loss_fwd_ms", P.ms(run))


def phase_assign_only(P):
    from dafne_torch.engine.trainer import batch_targets

    aspec, _, tables = P.specs()

    def run():
        t = batch_targets(P.b, aspec, tables)
        return sum(v.float().sum() for v in t.values())

    P.put("assign_only_ms", P.ms(run))


def _losses(P, grad: bool):
    from dafne_torch.engine.trainer import batch_targets, flatten_head
    from dafne_torch.ops.losses import dafne_losses

    aspec, lspec, tables = P.specs()
    out = P.head()
    with torch.no_grad():
        targets = batch_targets(P.b, aspec, tables)
    leaves = [t for v in out.values() for t in v if t is not None]

    def loss_of(o):
        return dafne_losses(*flatten_head(o, lspec.num_classes), targets, lspec)["loss/total"]

    def run():
        if not grad:
            with torch.no_grad():
                return loss_of(out)
        xs = [t.clone().requires_grad_() for t in leaves]
        it = iter(xs)
        o = {k: [None if t is None else next(it) for t in v] for k, v in out.items()}
        loss = loss_of(o)
        grads = torch.autograd.grad(loss, xs)
        return loss.detach() + sum(g.sum() for g in grads)

    return run


def phase_losses_only(P):
    P.put("losses_only_ms", P.ms(_losses(P, grad=False)))


def phase_losses_grad(P):
    P.put("losses_grad_ms", P.ms(_losses(P, grad=True)))


def phase_model_grad(P):
    P.put("model_grad_ms", P.ms(P.grad_program()))


def phase_eval_full(P):
    ms = P.ms(P.eval_program())
    P.put("eval_full_ms", ms)
    P.results.setdefault("mfu", {})["eval_full"] = mfu(P.work["eval_full"]["flops"], ms,
                                                       P.device)


def phase_eval_int8(P):
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.layers.quant import calibrate_act_scales, save_act_scales

    scales = calibrate_act_scales(P.model, [P.b["image"]], min_channels=64)
    with tempfile.TemporaryDirectory(prefix="int8_scales_") as tmp:
        path = os.path.join(tmp, "scales.json")
        save_act_scales(path, scales)
        ab = {}
        for key, min_ch, sp in (("bf16", 0, ""), ("min_ch_128", 128, ""),
                                ("min_ch_256", 256, ""), ("static_64", 64, path),
                                ("static_128", 128, path), ("static_256", 256, path)):
            cfg = flagship_cfg(P.opts, EVAL_INT8=min_ch > 0,
                               EVAL_INT8_MIN_CHANNELS=min_ch or 128, EVAL_INT8_SCALES=sp)
            step = make_eval_step(P.model, cfg, (P.hw, P.hw))

            def run(step=step):
                d = step(P.b["image"])
                return d["scores"].sum() + d["corners"].sum()

            ab[key] = P.ms(run)
            print(f"eval_int8[{key}]", ab[key], flush=True)
    P.results["eval_int8_ms"] = ab


def phase_model_fwd_int8(P):
    from dafne_torch.layers.quant import quantized_eval_model

    ab = {}
    for min_ch in (64, 128, 256):
        qmodel = quantized_eval_model(P.model, enabled=True, min_channels=min_ch)

        def run(qmodel=qmodel):
            with torch.inference_mode():
                return consume_all(qmodel(P.b["image"]))

        ab[f"min_ch_{min_ch}"] = P.ms(run)
        print(f"model_fwd_int8[{min_ch}]", ab[f"min_ch_{min_ch}"], flush=True)
    P.results["model_fwd_int8_ms"] = ab


def _nms_input(P):
    if not hasattr(P, "nms"):
        P.nms = nms_input(P.rng, P.batch, P.hw, int(flagship_cfg(P.opts).TPU.NMS_MAX_CANDIDATES),
                          P.device)
    return P.nms


def phase_nms_only(P):
    from dafne_torch.ops.nms import rotated_nms

    x = _nms_input(P)
    P.put("nms_only_ms", P.ms(lambda: rotated_nms(x["corners"], x["scores"], x["classes"],
                                                  x["valid"], 0.1, ((5, 4),)).sum()))


def phase_suppression_only(P, two_d: bool = False):
    from dafne_torch.ops.kernels import quad_nms as K

    x = _nms_input(P)
    f = K.suppression_bits_2d if two_d else K.suppression_bits
    key = "suppression_only_2d_ms" if two_d else "suppression_only_ms"
    P.put(key, P.ms(lambda: f(x["sorted_corners"], x["sorted_classes"], 0.1).sum()))


def phase_greedy_only(P):
    from dafne_torch.ops.kernels import quad_nms as K

    x = _nms_input(P)
    bits = K.suppression_bits(x["sorted_corners"], x["sorted_classes"], 0.1)
    P.put("greedy_only_ms", P.ms(lambda: K.greedy_keep_bits(bits, x["valid"]).sum()))


def _decode(P, **overrides):
    import dataclasses

    from dafne_torch.ops.postprocess import DecodeSpec, decode_detections

    out = P.head()
    spec = dataclasses.replace(DecodeSpec.from_config(P.cfg), **overrides)

    def run():
        with torch.inference_mode():
            d = decode_detections(out, spec)
        return d["scores"].sum() + d["corners"].sum()

    return run


def phase_decode_only(P):
    run = _decode(P)
    P.put("decode_only_ms", P.ms(run))
    P.put("decode_only_host_ms", P.host_ms(run))


def phase_decode_no_sort(P):
    P.put("decode_no_sort_ms", P.ms(_decode(P, sort_corners=False)))


def phase_train_step(P):
    ms = P.ms(P.step_program())
    P.put("train_step_ms", ms)
    P.results.setdefault("mfu", {})["train_step"] = mfu(P.work["train_step"]["flops"], ms,
                                                        P.device)


def phase_train_step_xla_assign(P):
    P.put("train_step_xla_assign_ms",
          P.ms(P.step_program("train_step_xla_assign", ASSIGN_IMPL="xla")))


def phase_eval_roofline(P):
    """eval_full split by program differencing (JAX :619-739): the forward,
    the same eval step with skip_nms (forward + decode), and the full one;
    each difference bounded by its own work."""
    from dafne_torch.tools.analyze_model import program_bytes, tensor_bytes

    ms_fwd = P.ms(P.fwd_program())
    ms_nonms = P.ms(P.eval_program("eval_no_nms", skip_nms=True))
    ms_full = P.ms(P.eval_program())
    fwd, nonms, full = P.work["model_fwd"], P.work["eval_no_nms"], P.work["eval_full"]
    head_bytes = tensor_bytes(P.head())  # read once by the decode
    det_bytes = P.nbytes["eval_no_nms"] - program_bytes(P.b["image"], P.model, ())
    decode = {"flops": max(nonms["flops"] - fwd["flops"], 0), "kernels": {}}
    nms = {"flops": max(full["flops"] - nonms["flops"], 0), "kernels": full["kernels"]}
    table = {
        "model_fwd": {**roofline_row(fwd, P.nbytes["model_fwd"], ms_fwd),
                      "compute_unit": "tensor cores (bf16)"},
        "decode_topk": {**roofline_row(decode, head_bytes + det_bytes, ms_nonms - ms_fwd),
                        "compute_unit": "not counted (top-k, gathers, corner sort)"},
        "nms": {**roofline_row(nms, sum(k["bytes"] for k in nms["kernels"].values()),
                               ms_full - ms_nonms),
                "compute_unit": "f32 without FMA (K1's same-class IoU pairs)"},
    }
    composite = sum(r["bound_ms"] for r in table.values())
    table["eval_full"] = {
        "measured_ms": ms_full, "composite_bound_ms": composite,
        "pct_of_composite_bound": composite / ms_full,
        "note": "random weights: the prior-probability class bias leaves few candidates "
                "over the threshold, so NMS is light here; the kernels' own lines time "
                "them on full inputs (chip_smoke.py)"}
    P.results["eval_roofline"] = table
    for k, v in table.items():
        print("eval_roofline", k, v, flush=True)


def phase_roofline(P):
    programs = {"model_fwd": P.fwd_program, "model_grad": P.grad_program,
                "eval_full": P.eval_program, "train_step": P.step_program}
    committed = {}  # a phase not run here: its time in the committed record of this device
    if os.path.exists(OUT):
        with open(OUT) as f:
            committed = json.load(f)
        if committed.get("device") != P.results["device"] or P.batch != 8 or P.hw != HW:
            committed = {}
    roofline = {}
    for name, make in programs.items():
        if name not in P.work:
            make()
        measured = P.results.get(f"{name}_ms", committed.get(f"{name}_ms"))
        roofline[name] = roofline_row(P.work[name], P.nbytes[name], measured)
        roofline[name]["mfu"] = (mfu(P.work[name]["flops"], measured, P.device)
                                 if measured else "not measured")
        print("roofline", name, roofline[name], flush=True)
    P.results["roofline"] = roofline


def phase_tta_r101(P):
    from dafne_torch.engine.tta import BucketedEvalSteps, build_tta_augs, tta_inference_single
    from dafne_torch.tools.analyze_model import build, load_cfg

    cfg = load_cfg(os.path.join(ROOT, "configs", "pre-trained", "dota-1.0_r101_ms.yaml"),
                   P.opts)
    model = build(cfg, P.device, P.seed)
    img = (P.rng.rand(1024, 1024, 3) * 255).astype(np.float32)
    steps = BucketedEvalSteps(cfg, model)
    n_augs = len(build_tta_augs(cfg, 1024, 1024))
    t0 = time.perf_counter()
    det = tta_inference_single(cfg, steps, img)  # builds the steps
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        det = tta_inference_single(cfg, steps, img)
    P.put("tta_r101", {"augs_per_image": n_augs, "build_plus_first_s": first_s,
                       "s_per_image": (time.perf_counter() - t0) / reps,
                       "detections": int(np.asarray(det["valid"]).sum()), "oom": False,
                       "note": "random weights; trained-weight TTA: TTA_CANARY_TORCH.json"})


PHASE_FNS = {
    "model_fwd": phase_model_fwd, "loss_fwd": phase_loss_fwd, "assign_only": phase_assign_only,
    "losses_only": phase_losses_only, "losses_grad": phase_losses_grad,
    "model_grad": phase_model_grad, "eval_full": phase_eval_full,
    "eval_int8": phase_eval_int8, "model_fwd_int8": phase_model_fwd_int8,
    "nms_only": phase_nms_only, "suppression_only": phase_suppression_only,
    "suppression_only_2d": lambda P: phase_suppression_only(P, two_d=True),
    "greedy_only": phase_greedy_only, "decode_only": phase_decode_only,
    "decode_no_sort": phase_decode_no_sort, "train_step": phase_train_step,
    "train_step_xla_assign": phase_train_step_xla_assign,
    "eval_roofline": phase_eval_roofline, "roofline": phase_roofline,
    "tta_r101": phase_tta_r101,
}


def run(phases, device: str, opts=(), batch: int = BATCH, hw: int = HW, iters: int = ITERS,
        warmup: int = WARMUP) -> dict:
    """The record of `phases` on `device` (not written): each phase's
    figures, "launches" {phase: {kernel: launches}}, "mfu", the cuDNN
    setting and the card's fields."""
    from dafne_torch.tools.canary import card_fields, cli_backend_flags

    check_phases(phases)
    with cli_backend_flags():
        cudnn = {"benchmark": torch.backends.cudnn.benchmark,
                 "allow_tf32": torch.backends.cudnn.allow_tf32,
                 "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        print("cudnn", cudnn, flush=True)
        P = Profile(device, opts, batch, hw, iters, warmup)
        P.results.update(card_fields(device))
        P.results["cudnn"] = cudnn
        P.results["iters"], P.results["warmup"] = iters, warmup
        launches = {}
        for name in PHASES:  # the JAX tool's order, whatever the order asked
            if name in phases:
                before = launch_counts()
                PHASE_FNS[name](P)
                if device == "cuda":
                    torch.cuda.synchronize()
                launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
        P.results["launches"] = launches
    return P.results


def write(results: dict, path: str, batch: int) -> dict:
    """Merge `results` into the JSON at `path` (partial runs accumulate: a
    key is replaced, but "launches" and "mfu", keyed by phase, gain the new
    phases); a batch other than 8 suffixes every key with _b<batch>."""
    if batch != 8:
        results = {f"{k}_b{batch}": v for k, v in results.items() if k != "batch"}
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        for k, v in results.items():
            by_phase = k.split("_b")[0] in ("launches", "mfu")
            prev[k] = {**prev[k], **v} if by_phase and isinstance(prev.get(k), dict) else v
        results = prev
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None) -> int:
    from dafne_torch.tools.analyze_model import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default="model_fwd,loss_fwd,train_step")
    p.add_argument("--out", default=OUT, help="the record, merged into an existing one")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--warmup", type=int, default=WARMUP)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--hw", type=int, default=HW, help="the square canvas")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="dotted-key config overrides")
    args = p.parse_args(argv)
    phases = [x for x in args.phases.split(",") if x]
    check_phases(phases)
    results = run(phases, resolve_device(args.cpu), args.opts, args.batch, args.hw, args.iters,
                  args.warmup)
    merged = write(results, args.out, args.batch)
    print(json.dumps(merged), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
