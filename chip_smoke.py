#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase's failure is caught):
  1. the card, and an nvcc build of dafne_torch/csrc/*.cu for sm_90a (and g++
     builds of the host libraries csrc/png_unfilter.cpp, image_warp.cpp and
     jpeg_decode.cpp);
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
 16. the HRSC2016 multi-scale recipe (configs/pre-trained/hrsc_r50_ms.yaml:
     R-50 at full width, 1 class, the 16-scale train ladder 320-1520, 30-
     degree rotations, eval at 800/1333): an HRSC2016 tree of
     N_HRSC_TRAIN + N_HRSC_TEST 24-bit BMPs of six non-square sizes (ships
     drawn as filled rotated rectangles, a planted point and axis-aligned
     segment on every fourth image) decoded bit for bit; the CLI with
     --config-file from an R-50.pkl, HRSC_STEPS steps at batch 8: the
     bucket ladder, at least two canvases hit (SEED HRSC_SEED), each
     canvas's step built once, K3 once per step, every loss finite; step
     ms per canvas, the host warps' ms per image on the loader's threads,
     map_ms, peak memory; K3 against its plain version on the tables of
     its canvases; --eval-only on hrsc_test (K1 and greedy once per batch,
     the planted objects dropped, eval img/s) and K1 and greedy against
     their plain versions on the non-square eval canvas; three requests
     of different sizes through Predictor (canvases equal to the eval
     mapper's, detections equal to do_test's on the same images); TTA on
     N_HRSC_TTA test images with 30-degree copies on the host, then with
     every copy on the host (TPU.TTA_DEVICE_AUG False): s/image, host warp
     and merge ms.  Every image the phase warps on the host is held bit for
     bit against the plain NumPy version.
 17. the model's options: the paper's ablation recipe through the CLI,
     each head or solver option alone, and the R-101 recipe with TTA.
     The ablation CLI run also drives the train loop's run-time services
     (check_services): DEBUG.PROFILE_ITERS SERVICES_WINDOW (its trace must
     name K3 and a convolution kernel), DAFNE_NOTIFY_CMD (its stdin must
     equal OUTPUT_DIR/run_report.json, status train_done), asynchronous
     saves every SERVICES_CKPT_PERIOD steps (the loop's blocking ms beside
     the writer's); then one save of the trained state synchronously and
     one asynchronously, the files equal, their ms and peak memory.
 18. several processes (dafne_torch/parallel/): the CLI as processes in
     one group at the DOTA-1.0 1024 recipe's width on N_DIST_SCENES
     synthetic 1024^2 scenes, from seeded weights with the class bias -2:
     (a) one NCCL rank, DIST_STEPS steps at batch 8 and do_test at batch
     4, its per-step losses against a plain do_train in this process (bit
     for bit, else within DIST_LOSS_RTOL, the difference printed); (b) two
     gloo ranks on the one card, batch 4 each, started beside (a): losses
     and final parameters against (a)'s within DIST_LOSS_RTOL and
     DIST_PARAM_ATOL, metrics.json and the evaluator's files written once,
     its detections against (a)'s printed; then two gloo ranks --eval-only on (a)'s checkpoint at
     global batch 8, held to (a)'s do_test (>= 99% of the detections
     matched within 1e-4 and 1e-2, mAP within 0.1); (c) (a)'s checkpoint resumed by
     two ranks to DIST_RESUME_TO (beside those --eval-only ranks), each
     metric row written once; (d) K3
     once per step and K1 and greedy once per eval batch on every rank,
     rank 0's train and eval inputs held to the plain versions; (e) two
     NCCL ranks on the one card, what NCCL says (not a pass condition);
     each rank's step ms and peak memory.  Launches under
     launches_by_path["distributed"].
 19. JPEG, the synthetic and ICDAR15 recipes, and the server: (a) every
     committed fixture of tests/data/jpeg decoded by csrc/jpeg_decode.cpp to
     the SHA-256 of cv2.imread's pixels recorded beside it (this script
     imports no cv2), and the decode of a 1280x720 JPEG timed; (b)
     configs/synthetic/base.yaml with the JAX package's canary overrides
     (SYN_IMAGES overfit scenes, SYN_ITERS steps, eval on synthetic_train)
     through the CLI, then --eval-only: K3 once per step, the loss falling,
     bf16 mAP above SYN_MAP_GATE; K3 and the NMS kernels held on the first
     train and eval batch; (c) python -m dafne_torch.tools.serve on (b)'s
     checkpoint: /healthz ok, PNG, .npy and JPEG bodies answered as the
     in-process Predictor.detect answers the same decoded image (request ms
     per body kind), 400 for an oversized header, a cut-off PNG and text;
     the ICDAR15 recipe (configs/icdar15/base.yaml) on a tree of the four
     1280x720 fixture JPEGs: ICDAR_STEPS train steps from the R-50.pkl,
     --eval-only with the recipe's 9-size flip TTA ladder on 2 test images
     (class bias -2), K1 and greedy held and timed on the eval canvas and
     the smallest and largest TTA canvases, K3 on the train canvas; the
     R-101 recipe's one eval batch.  Launches under launches_by_path
     ["synthetic"], ["serve"] (the server process's, from its /healthz),
     ["icdar15"] and ["icdar15_r101"].
 20. deformable convolution and the other backbones: (a) the sampler's
     kernels (csrc/deform_conv.cu) against deform_im2col_plain at every
     shape of the deformable path (DEFORM_SHAPES: the towers' P3-P7 and
     the trunk's res3-res5 inputs, batch 8), bf16, f16 and f32, with and
     without a mask, offsets in +-4 px: the forward bit-equal, the backward
     within DEFORM_BWD_TOL of the plain version's autograd; at P3 bf16 the
     kernels' ms and device ms, the plain version's (its backward timed
     alone), grid_sample's (and its backward's) and the bound; (b)
     configs/dota-1.0/1024.yaml with the deformable-interval R-50 and
     deformable towers through the CLI: DEFORM_STEPS steps from the
     R-50.pkl (K3 and the sampler's forward and backward once per call,
     finite losses), --eval-only on one batch (class bias -2: K1 and
     greedy once), every sampler call of that batch bit-equal to the plain
     version on the model's own offsets, K1, greedy and K3 held, one train
     step of that model in process with every sampler call's backward
     within DEFORM_BWD_TOL of the plain version's float32 autograd on the
     call's own inputs and gradient, one image's f32 forward on the card
     within DEFORM_CARD_CPU_TOL of the CPU's; (c) each of FAMILY_CASES (R-18,
     R-34, R-152, ResNet-LPF-50, DLA34, V-39-eSE, MobileNetV2) built on the
     card at full width: FAMILY_STEPS train steps (step ms, peak memory, K3
     held) and one eval batch (K1 and greedy held).  Launches under
     launches_by_path ["deform_train"], ["deform_eval"] and ["backbones"].
 21. export and artifact serving (phase_export): the DOTA-1.0 1024
     recipe's eval step with seeded random weights (class bias -2)
     exported by python -m dafne_torch.tools.export_model --batch 1 and
     replayed by --check, each in a process of its own (the export must
     call dafne::suppression_bits and dafne::greedy_keep_bits); python -m
     dafne_torch.tools.serve --artifact and live mode on the same
     checkpoint, each a process of its own, answering the same PNG, JPEG
     and .npy bodies of several sizes EXPORT_REPS times: the detection
     lists matched both ways (match_rate >= EXPORT_MATCH_GATE, bit-equal
     lists counted), request ms per body kind side by side, the artifact
     server's K1 and greedy launches once per request (/healthz, under
     launches_by_path ["export_serve"]); K1's bits and greedy's keep-set
     through torch.ops.dafne bit-equal to their plain versions on one
     request's NMS input, each op timed beside its direct launcher.
 22. int8 eval (phase_int8, TPU.EVAL_INT8): (a) the DOTA-1.0 1024 recipe's
     int8 eval programs at full width, batch 8, 1024^2 (seeded weights,
     class bias -2), dynamic (auto width 256) and static (auto width 64,
     scales from calibrate_act_scales on INT8_CALIB_BATCHES batches on the
     card): at every distinct quantized site of one forward the activation
     quantize (quantize_act) and the implicit-GEMM conv (int8_conv) of
     csrc/int8_conv.cu bit-equal to their plain versions; both timed at the
     P3 tower 3x3 and a res4 1x1 (events, device ms, plain ms, bound;
     torch._int_mm on the 1x1's matrix and the bf16 cuDNN conv as
     yardsticks the port never calls); (b) the eval step in bf16, int8
     dynamic and int8 static: step and forward ms, sites, launches equal to
     the site calls of a forward times the forwards, peak memory; the
     narrow float32 model's int8 eval step on the card against the CPU,
     free-running (printed: int8's own noise) and with the card's int8
     sites fed the CPU's inputs call for call (>= 99% of detections
     matched both ways); (c) phase 19's canary checkpoint evaluated in bf16,
     int8 dynamic and int8 static by int8_canary.evaluate (mAPs printed,
     not a gate), and through tools/calibrate_int8.py and the CLI's
     --eval-only TPU.EVAL_INT8 True in both modes (scales and mAPs held
     equal to evaluate's); (d) the static
     int8 eval step exported at batch 1 and served from the artifact beside
     live int8 mode, both as processes: the 1024^2 PNG and a JPEG answered
     with bit-equal detection lists, /healthz's int8 launches.  Launches
     under launches_by_path ["eval_int8"] and ["export_serve_int8"].
 23. the trained-weight gates, short (phase_gates): each gate tool's record
     function (dafne_torch/tools/int8_canary.py, tta_canary.py and
     gen_canary.py at 256 and 1024) at full width and a cut depth
     (GATE_OPTS: GATE_STEPS steps on GATE_SCENES scenes, GATE_1024_STEPS at
     1024): every field of the JAX package's record (and the port's added
     ones) present, every mAP finite, the held-out val ids disjoint from the
     train ids, the static calibration reading train images only, the TTA
     copies of image 0 equal to build_tta_augs's count, and the JAX
     package's four gate records (JAX_GATE_RECORDS) byte-identical before
     and after; the gates' thresholds are not held at this depth.  Launches
     under launches_by_path ["gate_int8"], ["gate_tta"], ["gate_gen256"]
     and ["gate_gen1024"].
 24. the measurement tools, short (phase_tools): analyze_model on the
     DOTA-1.0 1024 recipe at 1024^2 (its parameter total equal to the
     torch parameters plus the FrozenBN buffers, the former equal to
     sum(p.numel())), train_step_profile's phases that reach a kernel
     (TOOL_PHASES: K3, K1, K2, greedy, the eval step, the train step) and
     its roofline and eval_roofline at batch 8 and 1024^2 with TOOL_ITERS
     iterations, benchmark's eval and train tasks (the recipe on
     synthetic_gen1024_train), ablate_train_step's four variants; every
     record parses and holds the JAX tool's fields, every roofline share is
     at most TOOL_PCT_MAX, and K1, greedy, K3 and K2 launched.  Launches
     under launches_by_path ["tools"].

A failing phase prints "chip_smoke: phase <n> <name> failed: <message>"
on stdout before the nonzero exit.

The line before the last holds one JSON object with every kernel's numbers
(K1's and greedy's launches from phases 4, 11's CLI run, 13's TTA run,
15's two CLI runs, 16's eval, serve and TTA runs, 17, 18, 19, 20 and 21's
artifact server, and their "op_ms" through torch.ops.dafne, K3's
from phases 7, 14, 15's and 16's CLI runs, 17, 18, 19 and 20, K2's from
phase 11's replay, the deformable sampler's from phase 20's CLI runs, the
int8 kernels' from phase 22's eval steps and artifact server, and K1's,
greedy's, K3's and the int8 kernels' from phase 23's gates, K1's,
greedy's, K3's and K2's from phase 24's tools;
"launches_by_path" splits them); the last line is {"ok": true, "device": {...}}.  Every time printed is
measured in this run, on the card named by the nvidia-smi line: kernel_ms
(and "ms" in the kernels line) on CUDA events around the wrapper's call,
which hold the wrapper's host time when the card waits for the launch;
device_ms (also in the kernels line) from a torch.profiler trace, the
kernel alone.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import io
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
import traceback
import zipfile
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the published H100 SXM peaks and the timers (dafne_torch/utils/measure.py)
from dafne_torch.utils.measure import (  # noqa: E402
    F32_FLOPS,
    F32_OPS_NO_FMA,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
    bound,
    cuda_ms,
    device_ms,
    host_ms,
)

# kernel names as the profiler reports them
K1_KERNEL, GREEDY_KERNEL = "suppression_bits_kernel", "greedy_keep_bits_kernel"
K2_KERNEL, K3_KERNEL = "suppression_bits_2d_kernel", "assign_argmin_kernel"

# traces per kernel count: a trace drops events now and then, in runs of
# up to 10 of one call's 57 kernels in all 3 traces of a call once
KERNEL_COUNT_TRACES = 8
# rounds of such traces (pallas, pallas-2d, pallas) in phase 11's kernel
# comparison: all 8 traces of one call have missed the same 6 events (the
# call's first: a profiler session loses its first events, which
# ``device_kernels`` now spends on a discarded warm-up call), so a round
# whose maxima differ is traced again, each name keeping its most over
# every round; the counts are then the same or a kernel is extra
KERNEL_COUNT_ROUNDS = 4
# calls of a plain version timed outside the kernels line (phases 2, 3 and
# time_nms), each right after a call of the same plain version, so warm:
# the plain versions at N = 4096 take a second or more a call
PLAIN_REPS = 1

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
N_TTA_SCENES = 2  # scenes through the TTA CLI
# the DOTA-1.0 1024 recipe's TTA ladder (configs/dota-1.0/1024.yaml): with
# HFLIP and VFLIP, 15 copies per image on canvases 256, 512, 768, 1024, 1536
TTA_MIN_SIZES, TTA_MAX_SIZE = "(256, 512, 756, 1024, 1536)", 1536
WARP_TOL = 1e-3  # rendered TTA copies against the CPU, 0-255 scale
# timed steps per run of the device-aug against host-aug comparison (10, and
# FILE_AB_STEPS 20, before phase 20 joined the run: its time is cut here)
DA_STEPS = 5
N_FILE_VAL = 16  # val tiles of the DOTA tree on disk (train: the N_TRAIN_SCENES scenes)
FILE_STEPS = 4  # train steps of the CLI run from files
FILE_AB_STEPS = 6  # timed steps per run of the files against in-memory comparison
# phase 16: the HRSC2016 multi-scale recipe (configs/pre-trained/hrsc_r50_ms.yaml)
HRSC_RECIPE = os.path.join("configs", "pre-trained", "hrsc_r50_ms.yaml")
N_HRSC_TRAIN, N_HRSC_TEST = 16, 16  # trainval and test BMPs of the HRSC tree
HRSC_STEPS = 12  # train steps through the CLI
HRSC_SEED = 0  # SEED: its per-batch scale draws hit all 4 canvases of the ladder in 12 steps
HRSC_TTA_SIZES = "(640, 800, 960)"  # the recipe's 16-scale TTA ladder, cut for time
N_HRSC_TTA = 1  # test images through TTA
# phase 17: the paper's ablation recipe, each other head or solver option, R-101
ABLATION_RECIPE = os.path.join("configs", "paper", "ablation", "dota-1.0-base.yaml")
ABL_STEPS = 3  # train steps of the ablation recipe through the CLI
OPT_STEPS = 2  # train steps of each option
OPTION_CASES = [  # one option at a time over the DOTA-1.0 1024 recipe
    ("iterative corners", ["MODEL.DAFNE.CORNER_PREDICTION", "iterative"]),
    ("offset corners", ["MODEL.DAFNE.CORNER_PREDICTION", "offset"]),
    ("angle corners", ["MODEL.DAFNE.CORNER_PREDICTION", "angle"]),
    ("merged center-to-corner", ["MODEL.DAFNE.MERGE_CORNER_CENTER_PRED", "True"]),
    ("BN towers", ["MODEL.DAFNE.NORM", "BN"]),
    ("SyncBN towers", ["MODEL.DAFNE.NORM", "SyncBN"]),
    # without a norm the random head meets the random trunk's FPN features
    # unnormalized: the first loss is ~1e4 and an unclipped step overflows
    # (this phase on an H100 without the clip: loss/cls 8809, then NaN), so
    # this case clips each group's gradient norm at 1
    ("no-norm towers", ["MODEL.DAFNE.NORM", "none", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                        "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                        "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0"]),
    ("Mish", ["MODEL.DAFNE.USE_RELU", "False"]),
    ("TOP_MODULE conv", ["MODEL.TOP_MODULE.NAME", "conv"]),
    ("Adam", ["SOLVER.OPTIMIZER", "adam"]),
]
R101_RECIPE = os.path.join("configs", "pre-trained", "dota-1.0_r101_ms.yaml")
R101_STEPS = 8  # bucketed train steps through the CLI
R101_SEED = 3  # SEED: its per-batch scale draws hit all 4 canvases of the ladder in 8 steps
R101_TTA_SIZES = "(600, 1024)"  # the recipe's 9-scale TTA ladder, cut for time
N_R101_EVAL = 4  # val tiles of the R-101 evaluation and TTA (DEBUG.OVERFIT_NUM_IMAGES)
# phase 18: several processes through the CLI, on phase 11's synthetic 1024^2 set
N_DIST_SCENES = 16  # train and val scenes (DEBUG.OVERFIT_NUM_IMAGES): 2 eval batches of 8
DIST_STEPS, DIST_RESUME_TO = 5, 7  # train steps; the elastic resume's last step
DIST_TIMEOUT_S = 300  # each CLI process's limit: a rank waiting on a missing peer fails
NCCL_TRY_TIMEOUT_S = 60  # (e): NCCL with two ranks on one card
# two bf16 ranks at batch 4 against one at batch 8: cuDNN may pick other
# algorithms per batch, so each forward rounds differently; the tolerances
# of the losses (relative, per step) and of the final parameters (absolute),
# and the looser match of a detection (score, corner pixels) printed beside
# match_rate's
DIST_LOSS_RTOL, DIST_PARAM_ATOL, DIST_MATCH_TOL = 1e-2, 1e-3, (5e-3, 2.0)
SYN_RECIPE = os.path.join("configs", "synthetic", "base.yaml")  # the data-free smoke recipe
SYN_ITERS = 800  # the JAX package's canary: tools/int8_canary.py:46-66
SYN_IMAGES = 32  # DEBUG.OVERFIT_NUM_IMAGES of the canary, evaluated on synthetic_train
SYN_MAP_GATE = 50.0  # the canary's convergence gate (tools/int8_canary.py:14-15)
JAX_CANARY_MAP = 82.36  # the JAX package's bf16 canary mAP on its TPU (INT8_CANARY.json)
SERVE_REPS = 5  # requests per body kind through the HTTP server
JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")
ICDAR_RECIPE = os.path.join("configs", "icdar15", "base.yaml")
ICDAR_R101_RECIPE = os.path.join("configs", "icdar15", "r101.yaml")
ICDAR_STEPS = 3  # train steps of the ICDAR15 recipe through the CLI
# phase 20: deformable convolution and the other backbones
DEFORM_RECIPE = os.path.join("configs", "dota-1.0", "1024.yaml")
DEFORM_ARGS = ["MODEL.BACKBONE.NAME", "build_resnet_interval_backbone",
               "MODEL.DAFNE.USE_DEFORMABLE", "True"]
DEFORM_STEPS = 3  # train steps of the deformable recipe through the CLI
# the deformable sampler's inputs on that path at 1024^2, batch 8: [C, H, W]
# of the head towers' last conv at P3-P7 and of the trunk's 3x3s in res3-res5
DEFORM_SHAPES = {"P3": (256, 128, 128), "P4": (256, 64, 64), "P5": (256, 32, 32),
                 "P6": (256, 16, 16), "P7": (256, 8, 8), "res3": (128, 128, 128),
                 "res4": (256, 64, 64), "res5": (512, 32, 32)}
DEFORM_OFFSET_PX = 4.0  # offsets drawn in +-4 px: samples between pixels and off the map
# the backward against the plain version's autograd, atol over max|plain
# gradient|: float32 sums in another order (atomics in no fixed order);
# bfloat16's and float16's plain autograd rounds each product and the
# scatter of the gradient of x to the feature dtype, the kernel sums in
# float32.  float16 keeps 3 more mantissa bits than bfloat16 (unit
# roundoff 2^-11 against 2^-8), so its tolerance is a fifth of bfloat16's
DEFORM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2, torch.float16: 1e-2}
DEFORM_DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # the kernel's dtypes
# the float32 forward of one 1024^2 image on the card against the CPU's
# plain path, atol over max|CPU output|: cuDNN's and oneDNN's sums over
# 2304 stacked taps in other orders, through 28 deformable convs
DEFORM_CARD_CPU_TOL = 1e-3
FAMILY_STEPS = 2  # train steps of each other backbone
FAMILY_CASES = [  # each over the DOTA-1.0 1024 recipe, full width
    # Detectron2's ResNet-18/34 widths (RES2_OUT_CHANNELS 64)
    ("R-18", ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64"]),
    ("R-34", ["MODEL.RESNETS.DEPTH", "34", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64"]),
    ("R-152", ["MODEL.RESNETS.DEPTH", "152"]),
    ("ResNet-LPF-50", ["MODEL.BACKBONE.NAME", "build_resnet_lpf_backbone"]),
    ("DLA34", ["MODEL.BACKBONE.NAME", "build_dafne_dla_fpn_backbone"]),
    ("V-39-eSE", ["MODEL.BACKBONE.NAME", "build_vovnet_fpn_backbone"]),
    ("MobileNetV2", ["MODEL.BACKBONE.NAME", "build_mnv2_backbone"]),
]
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


#: the phase running now, named in the failure line, and when it began
PHASE = {"n": 0, "name": "set-up", "t0": time.perf_counter()}
#: wall seconds of each phase that has ended, by number
PHASE_S = {}


def phase(n, name):
    """Start phase `n`, ending the one before (its wall time kept in PHASE_S)."""
    now = time.perf_counter()
    PHASE_S[PHASE["n"]] = round(now - PHASE["t0"], 1)
    PHASE.update(n=n, name=name, t0=now)


def run() -> int:
    """``main``, with any failure named by its phase on stdout and stderr, then a
    nonzero exit: a ``SystemExit`` from a check, any exception, or a
    nonzero return.  Nothing is caught into exit code 0."""
    try:
        rc = main()
    except SystemExit as e:
        if e.code in (0, None):
            raise
        msg = e.code if isinstance(e.code, str) else f"exit code {e.code}"
        failed(f"chip_smoke: phase {PHASE['n']} {PHASE['name']} failed: {msg}")
        return 1
    except Exception as e:
        traceback.print_exc()
        failed(f"chip_smoke: phase {PHASE['n']} {PHASE['name']} failed: {type(e).__name__}: {e}")
        return 1
    if rc:
        failed(f"chip_smoke: phase {PHASE['n']} {PHASE['name']} failed: exit code {rc}")
    return rc


def failed(line):
    """The failure line on stdout and on stderr, so that a reader of
    either stream's end sees which phase failed and why."""
    log(line)
    print(line, file=sys.stderr, flush=True)


def device_kernels(fn, traces=3):
    """{kernel name: launches} (fills and copies included) of one call of
    fn() on the card, from torch.profiler traces after one warm-up call:
    per name the most of `traces` traces, since a trace drops events now
    and then.  A profiler session loses its first events, so each trace
    records a warm-up call that the schedule discards, then the call it
    keeps, as ``device_ms`` does."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    most = Counter()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up call, then the kept one
                fn()
                torch.cuda.synchronize()
                prof.step()
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                most[e.key] = max(most[e.key], e.count)
    return most


def fmt_ms(ms, digits=4):
    return "not measured" if ms is None else f"{ms:.{digits}f}"


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


def full_gts(rng, b, m):
    """gt tensors on the card with all m slots valid: rotated rectangles of
    DOTA-like sizes, canonically sorted."""
    from dafne_torch.geometry.quads import enclosing_hbox, quad_area, sort_quadrilateral

    corners = sort_quadrilateral(torch.from_numpy(random_quads(rng, b, m))).cuda()
    return {"gt_corners": corners, "gt_hbox": enclosing_hbox(corners).contiguous(),
            "gt_classes": torch.from_numpy(rng.randint(0, 15, (b, m)).astype(np.int32)).cuda(),
            "gt_area": quad_area(corners).contiguous(),
            "gt_valid": torch.ones((b, m), dtype=torch.bool, device="cuda")}


def assign_equal(spec, tables, g, what):
    """K3 against its plain version on the gts `g` and a canvas's location
    tables: raises unless min_area is bit-equal and argmin equal.  Returns
    (max |min_area diff|, (min_area, argmin), the kernel's arguments)."""
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
    return err, (km, ka), args


def check_assign(spec, tables, g, what, card):
    """``assign_equal``, then K3's times, pairs and bound on `g`.  Returns
    (kernel ms, device ms, plain ms, bound ms, bound_by, max |min_area
    diff|, (min_area, argmin))."""
    from dafne_torch.ops.kernels import assign as A

    err, (km, ka), args = assign_equal(spec, tables, g, what)
    locations, loc_strides, size_ranges = tables[1:]
    (b, m), k = g["gt_valid"].shape, locations.shape[0]
    pairs = A.pair_counts(locations, loc_strides, size_ranges, g["gt_hbox"], g["gt_valid"], spec)
    (bound, by), valid_bound, no_fma = A.assign_bound(pairs, k, b, m)
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


def nms_kernel_inputs(head, spec):
    """The NMS kernels' input of one decode of the head outputs `head`, as
    ``decode_detections`` builds it for `spec`'s path (grouped or global
    cap): (corners, classes, keep_init)."""
    from dafne_torch.ops.nms import grouped_nms_inputs, single_group_inputs, sorted_nms_inputs
    from dafne_torch.ops.postprocess import nms_candidates

    c = nms_candidates(head, spec)
    if spec.nms_group_candidates > 0:
        return single_group_inputs(*grouped_nms_inputs(
            c["corners"], c["scores"], c["classes"], c["valid"], spec.class_merge,
            spec.num_classes, spec.nms_group_candidates,
            max(spec.nms_max_candidates, spec.post_nms_topk))[1:])
    return sorted_nms_inputs(c["corners"], c["scores"], c["classes"], c["valid"],
                             spec.class_merge, scores01=True)[1:]


def hold_nms(head, spec, what):
    """K1's bits against the packed plain S and greedy's keep-set against
    the plain walk on one decode's NMS input.  Returns (rows, valid slots,
    kept)."""
    pc, pk, pv = nms_kernel_inputs(head, spec)
    bits, s = check_k1(pc, pk, spec.nms_threshold, what)
    keep = check_greedy(bits, s, pv, what)
    return list(pk.shape), int(pv.sum()), int(keep.sum())


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
    (bound, by), pairs, no_fma, layouts = K.suppression_bound(classes, n)
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


def match_rate(got, want, score_tol=1e-4, corner_tol=1e-2):
    """(matched, total): how many of `want`'s detections (do_test's
    per-image "preds") have one in `got` of the same image and class, score
    within `score_tol` and corners within `corner_tol`."""
    matched = total = 0
    for image_id, w in want.items():
        g = got.get(image_id, {"classes": np.zeros(0), "scores": np.zeros(0),
                               "corners": np.zeros((0, 8))})
        total += len(w["scores"])
        for c, sc, box in zip(w["classes"], w["scores"], w["corners"]):
            matched += bool(((g["classes"] == c) & (np.abs(g["scores"] - sc) <= score_tol)
                             & (np.abs(g["corners"] - box).max(1) <= corner_tol)).any())
    return matched, total


def gt_tensors(examples, device):
    from dafne_torch.data.loader import GT_KEYS

    return {k: torch.from_numpy(np.stack([e[k] for e in examples])).to(device) for k in GT_KEYS}


def narrow_step_card_vs_cpu(ncfg, examples, seed):
    """One train step of `ncfg`'s narrow float32 model at 256^2 on the CPU
    (plain versions) and on the card (kernels), from the same weights and
    the same batch of mapped `examples`.  Returns (share of locations with
    equal labels, locations, {loss term: relative difference}, max |param
    diff| after the step, max |running-statistic diff| over the largest
    running statistic (0.0 without BN towers), the CPU's metrics)."""
    from dafne_torch.engine.optimizer import build_optimizer
    from dafne_torch.engine.trainer import batch_targets, make_location_tables, make_train_step
    from dafne_torch.models import build_model
    from dafne_torch.ops.targets import AssignmentSpec

    results = {}
    cpu_model = build_model(ncfg, device="cpu", generator=torch.Generator().manual_seed(seed))
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
    running = [k for k in p_cpu if ".running_" in k and k.startswith("head.")]
    p_err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu if k not in running)
    stat_err = max((float((p_gpu[k] - p_cpu[k]).abs().max() / p_cpu[k].abs().max().clamp(min=1e-12))
                    for k in running), default=0.0)
    return same_labels, l_cpu.numel(), rel, p_err, stat_err, m_cpu


# ---- 18. helpers: several processes through the CLI -------------------------

def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(args, out_dir, world, flags=(), collectives="gloo", timeout=DIST_TIMEOUT_S):
    """`world` processes of ``python -m dafne_torch.tools.train`` in one
    process group (the environment contract of dafne_torch/parallel/
    distributed.py), every one on card 0 (LOCAL_RANK 0), with collectives
    `collectives` ("gloo", or "" for the backend's own: NCCL on the card);
    each waited for within `timeout` s, the rest killed once one times out.
    Returns [(exit code, output)] in rank order."""
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("DAFNE_") and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    base.update(PYTHONPATH=ROOT, DAFNE_COORDINATOR=f"localhost:{port}",
                DAFNE_NUM_PROCESSES=str(world), LOCAL_RANK="0", DAFNE_DIST_TIMEOUT_S="120")
    if "DAFNE_DATA_DIR" in os.environ:
        base["DAFNE_DATA_DIR"] = os.environ["DAFNE_DATA_DIR"]
    if collectives:
        base["DAFNE_CPU_COLLECTIVES"] = collectives
    cmd = [sys.executable, "-m", "dafne_torch.tools.train", *flags, *args, "OUTPUT_DIR", out_dir]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env={**base, "DAFNE_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    return procs


def wait_ranks(procs, timeout=DIST_TIMEOUT_S):
    out = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, text))
    except subprocess.TimeoutExpired:
        out = [(None, "timed out")] * len(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def run_ranks(args, out_dir, world, what, flags=(), collectives="gloo"):
    """``launch_ranks`` and ``wait_ranks``; raises unless every process
    exits 0.  Returns each rank's run summary (the CLI's last log line)."""
    return rank_results(wait_ranks(launch_ranks(args, out_dir, world, flags, collectives)), world,
                        what)


def rank_results(res, world, what):
    """Each rank's run summary of ``wait_ranks``'s results; raises unless
    every process exited 0."""
    for r, (rc, text) in enumerate(res):
        if rc != 0:
            raise SystemExit(f"{what}: rank {r} of {world} exited {rc}: ...{text[-3000:]}")
    return [rank_summary(text) for _, text in res]


def rank_summary(text):
    lines = [ln for ln in text.splitlines() if "run summary " in ln]
    if not lines:
        raise SystemExit(f"a CLI process printed no run summary: ...{text[-2000:]}")
    return json.loads(lines[-1].split("run summary ", 1)[1])


def read_task1(out_dir, dataset, classes):
    """do_test's Task1 files as per-image detections {image id: {"classes",
    "scores", "corners"}} (scores to 4 decimals, corners to 2)."""
    per = {}
    d = os.path.join(out_dir, "inference", dataset, "task1")
    for ci, name in enumerate(classes):
        with open(os.path.join(d, f"Task1_{name}.txt")) as f:
            for ln in f:
                parts = ln.split()
                p = per.setdefault(parts[0], {"classes": [], "scores": [], "corners": []})
                p["classes"].append(ci)
                p["scores"].append(float(parts[1]))
                p["corners"].append([float(v) for v in parts[2:10]])
    return {k: {"classes": np.array(v["classes"]), "scores": np.array(v["scores"]),
                "corners": np.array(v["corners"]).reshape(-1, 8)} for k, v in per.items()}


def read_results(out_dir, dataset):
    with open(os.path.join(out_dir, "inference", dataset, "results.txt")) as f:
        return {k: float(v) for k, v in (ln.split(": ") for ln in f.read().splitlines())}


def metric_rows(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(ln)["iteration"] for ln in f]


def phase_distributed(card):
    """Phase 18: the CLI in several processes at the DOTA-1.0 1024 recipe's
    full width.  Returns the phase's kernel launches (every rank of every
    run) for the kernels line."""
    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import eval_pad_hw, pad_target_hw
    from dafne_torch.data.synthetic import GEN_CLASSES
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.engine.train_loop import do_train, to_device
    from dafne_torch.engine.trainer import make_location_tables
    from dafne_torch.models import build_model
    from dafne_torch.ops.postprocess import DecodeSpec
    from dafne_torch.ops.targets import AssignmentSpec

    t18 = time.perf_counter()
    root = os.path.join(ROOT, "output", "chip_smoke_dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    train_set, val_set = "synthetic_gen1024_train", "synthetic_gen1024_val"
    args = DOTA_1024 + [
        "DATASETS.TRAIN", f"('{train_set}',)", "DATASETS.TEST", f"('{val_set}',)",
        "DEBUG.OVERFIT_NUM_IMAGES", str(N_DIST_SCENES), "SOLVER.MAX_ITER", str(DIST_STEPS),
        "INPUT.MIN_SIZE_TEST", str(CANVAS), "TPU.EVAL_BATCH", str(BATCH),
        "TPU.NMS_GROUP_CANDIDATES", str(GROUP_K), "TPU.TRAIN_DEVICE_AUG", "False", "SEED", "7",
    ]
    cfg = get_cfg()
    cfg.merge_from_list(args)
    # seeded weights with the class bias -2 (as phases 4 and 11), so that the
    # eval's NMS inputs are full; every run of the phase starts from them
    init = os.path.join(root, "init.pth")
    m0 = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(18))
    with torch.no_grad():
        m0.head.cls_logits.bias.fill_(-2.0)
    torch.save(m0.state_dict(), init)
    init_sd = {k: v.float().cpu() for k, v in m0.state_dict().items()}
    del m0
    args += ["MODEL.WEIGHTS", init]
    cfg.merge_from_list(["MODEL.WEIGHTS", init])
    n_eval_batches = -(-N_DIST_SCENES // BATCH)

    # (a) one rank, NCCL, beside a plain do_train of the same seed in this process
    dir_a, dir_plain = os.path.join(root, "one_rank"), os.path.join(root, "plain")
    t0 = time.perf_counter()
    # (a) evaluates at batch 4, each rank's share of (b)'s global 8: in bf16
    # the card's convolutions round by batch size (cuDNN's algorithm per
    # shape), and a random model's dense NMS turns a last-bit score change
    # into other kept boxes, so only equal per-forward batches can give the
    # same detections
    procs = launch_ranks(args + ["TPU.EVAL_BATCH", str(BATCH // 2)], dir_a, 1, collectives="")
    # (b) two ranks on the one card, gloo, batch 4 each, started beside (a):
    # it reads nothing of (a) until both have ended
    dir_b = os.path.join(root, "two_ranks")
    procs_b = launch_ranks(args, dir_b, 2)
    try:
        register_all_datasets(cfg)
        records = get_dataset(train_set, cfg)
        pcfg = copy.deepcopy(cfg)
        pcfg.merge_from_list(["OUTPUT_DIR", dir_plain])
        flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
        # the CLI process's defaults, so that cuDNN picks the same algorithms
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = False, True
        pmodel = build_model(pcfg, device="cuda", generator=torch.Generator().manual_seed(7))
        pstats = {}
        do_train(pcfg, pmodel, records, stats=pstats)
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = flags
        del pmodel
        (rc, text), = wait_ranks(procs)
        if rc != 0:
            raise SystemExit(f"(a) one NCCL rank exited {rc}: ...{text[-3000:]}")
        (sa,) = [rank_summary(text)]
        a_s = time.perf_counter() - t0
        (plain_steps,) = pstats["steps"].values()
        plain_loss = plain_steps["loss"]
        loss_diff = [abs(x - y) for x, y in zip(sa["loss"], plain_loss)]
        bit_equal = sa["loss"] == plain_loss
        log(f"[dist a] one rank, NCCL (DAFNE_NUM_PROCESSES=1): {DIST_STEPS} steps at batch "
            f"{BATCH}, then do_test on {N_DIST_SCENES} scenes, in {a_s:.1f} s wall beside a plain "
            f"do_train in this process and (b)'s ranks; per-step total loss "
            f"{json.dumps(sa['loss'])}; plain do_train "
            f"{json.dumps(plain_loss)}; bit for bit equal: {bit_equal}, max |diff| "
            f"{max(loss_diff):.3g} at step {int(np.argmax(loss_diff)) + 1} [{card}]")
        if sa["world"] != 1 or sa["backend"] != "nccl":
            raise SystemExit(f"(a) did not run as one NCCL rank: {sa}")
        if len(sa["loss"]) != DIST_STEPS or not all(np.isfinite(sa["loss"])):
            raise SystemExit(f"(a) losses missing or not finite: {sa['loss']}")
        if not bit_equal and max(loss_diff) > DIST_LOSS_RTOL * max(abs(x) for x in plain_loss):
            raise SystemExit("(a) one NCCL rank's losses differ from a plain do_train's")
    except BaseException:
        wait_ranks(procs + procs_b, timeout=0)  # kills what still runs
        raise

    sb = rank_results(wait_ranks(procs_b), 2, "(b) two gloo ranks")
    b_s = time.perf_counter() - t0
    if [s["backend"] for s in sb] != ["gloo", "gloo"] or sb[0]["loss"] != sb[1]["loss"]:
        raise SystemExit(f"(b) not two gloo ranks with the same global losses: {sb}")
    rel = [abs(x - y) / abs(y) for x, y in zip(sb[0]["loss"], sa["loss"])]
    pa = torch.load(os.path.join(dir_a, "checkpoints", f"model_{DIST_STEPS:07d}.pth"),
                    map_location="cpu", weights_only=True)["model"]
    pb = torch.load(os.path.join(dir_b, "checkpoints", f"model_{DIST_STEPS:07d}.pth"),
                    map_location="cpu", weights_only=True)["model"]
    p_err = max(float((pb[k].float() - pa[k].float()).abs().max()) for k in pa)
    moved = max(float((pa[k].float() - init_sd[k]).abs().max()) for k in pa)
    det_a = read_task1(dir_a, val_set, GEN_CLASSES)
    det_b = read_task1(dir_b, val_set, GEN_CLASSES)
    res_a, res_b = read_results(dir_a, val_set), read_results(dir_b, val_set)
    trained = match_rate(det_b, det_a, *DIST_MATCH_TOL)
    # the two ranks' evaluation alone: --eval-only on (a)'s checkpoint, while
    # (c)'s two ranks resume (a)'s checkpoint beside them (both start from it)
    dir_e = os.path.join(root, "two_ranks_eval")
    shutil.copytree(os.path.join(dir_a, "checkpoints"), os.path.join(dir_e, "checkpoints"))
    dir_c = os.path.join(root, "elastic")
    shutil.copytree(dir_a, dir_c, ignore=shutil.ignore_patterns("inference", "test_results.csv"))
    t0 = time.perf_counter()
    procs_c = launch_ranks(args + ["SOLVER.MAX_ITER", str(DIST_RESUME_TO), "DATASETS.TEST", "()"],
                           dir_c, 2, flags=("--resume",))
    try:
        se = run_ranks(args, dir_e, 2, "(b) two gloo ranks, --eval-only", flags=("--eval-only",))
        e_s = time.perf_counter() - t0
    finally:
        res_c = wait_ranks(procs_c)
    c_s = time.perf_counter() - t0
    det_e, res_e = read_task1(dir_e, val_set, GEN_CLASSES), read_results(dir_e, val_set)
    matched, total = match_rate(det_e, det_a)  # score within 1e-4, corners within 1e-2
    loose = match_rate(det_e, det_a, *DIST_MATCH_TOL)[0]
    task1_dir = os.path.join("inference", val_set, "task1")
    same_files = not subprocess.run(["diff", "-rq", os.path.join(dir_a, task1_dir),
                                     os.path.join(dir_e, task1_dir)],
                                    capture_output=True, timeout=60).returncode
    written = sorted(os.listdir(dir_b))
    rows_b = metric_rows(dir_b)
    with open(os.path.join(dir_b, "test_results.csv")) as f:
        csv_rows = len(f.read().splitlines())
    per_rank = [{"rank": s["rank"], "step_ms_median": round(statistics.median(s["step_ms"][1:]), 2),
                 "first_step_ms": round(s["step_ms"][0], 1),
                 "peak_memory_gib": s["peak_memory_gib"]} for s in [sa] + sb]
    log(f"[dist b] two ranks on the one card, gloo (batch {BATCH // 2} each): {b_s:.1f} s wall "
        f"from (a)'s start, beside it; "
        f"per-step total loss {json.dumps(sb[0]['loss'])}; relative to (a) max "
        f"{max(rel):.3g} (tolerance {DIST_LOSS_RTOL}); final params max |diff| {p_err:.3g} "
        f"(tolerance {DIST_PARAM_ATOL}; the largest move from the initial weights in (a) "
        f"{moved:.3g}); files {written}, metrics.json rows {rows_b}, test_results.csv "
        f"{csv_rows} lines; its detections (of its own weights) {trained[0]} of {trained[1]} of "
        f"(a)'s matched (score within {DIST_MATCH_TOL[0]}, corners within {DIST_MATCH_TOL[1]} px)"
        f", mAP {res_b['mAP']:.4f} against (a)'s {res_a['mAP']:.4f} (not a pass condition: "
        f"bf16 steps at batch 4 and 8 round apart) [{card}]")
    log(f"[dist b] two gloo ranks --eval-only on (a)'s checkpoint at global batch {BATCH} "
        f"({e_s:.1f} s wall, (c)'s two ranks beside them), against (a)'s do_test at batch {BATCH // 2}: detections {matched} "
        f"of {total} matched (score within 1e-4, corners within 1e-2; {loose} within "
        f"{DIST_MATCH_TOL[0]} and {DIST_MATCH_TOL[1]} px; Task1 files identical: {same_files}), "
        f"mAP {res_e['mAP']:.4f} against {res_a['mAP']:.4f} [{card}]")
    log(f"[dist] per rank (a: rank 0 of 1; b: ranks 0, 1 of 2), step ms on CUDA events, peak "
        f"memory from torch.cuda.max_memory_allocated: {json.dumps(per_rank)} [{card}]")
    if max(rel) > DIST_LOSS_RTOL or p_err > DIST_PARAM_ATOL:
        raise SystemExit("(b) two ranks' losses or parameters differ from one rank's")
    if total == 0 or matched < 0.99 * total or abs(res_e["mAP"] - res_a["mAP"]) > 0.1:
        raise SystemExit("(b) two ranks' detections or mAP differ from one rank's")
    if (rows_b != [1] or csv_rows != 1 + len(res_b) or "log.txt.rank1" not in written
            or [f for f in written if f.startswith("error")]):
        raise SystemExit("(b) the ranks did not write their files once, by rank 0")

    # (c) elastic: (a)'s last checkpoint resumed under two ranks to
    # DIST_RESUME_TO (run beside (b)'s --eval-only ranks above)
    sc = rank_results(res_c, 2, "(c) elastic resume")
    rows_c = metric_rows(dir_c)
    log(f"[dist c] (a)'s step-{DIST_STEPS} checkpoint resumed by two gloo ranks to step "
        f"{DIST_RESUME_TO} in {c_s:.1f} s wall (beside (b)'s --eval-only ranks): losses "
        f"{json.dumps(sc[0]['loss'])}, metrics.json rows {rows_c}, checkpoints "
        f"{sorted(os.listdir(os.path.join(dir_c, 'checkpoints')))} [{card}]")
    if (rows_c != [1, DIST_STEPS + 1] or [len(s["loss"]) for s in sc] != [2, 2]
            or not all(np.isfinite(sc[0]["loss"]))):
        raise SystemExit("(c) the elastic resume did not continue once to the next steps")

    # (d) the kernels on every rank, and rank 0's inputs against their plain versions
    want = {"a": (DIST_STEPS, 2 * n_eval_batches), "b": (DIST_STEPS, n_eval_batches),
            "e": (0, n_eval_batches), "c": (DIST_RESUME_TO - DIST_STEPS, 0)}
    counts = {}
    for run, sums in (("a", [sa]), ("b", sb), ("e", se), ("c", sc)):
        for s in sums:
            la = s["launches"]
            counts[f"{run}{s['rank']}"] = la
            k3, nms = want[run]
            if (la["assign_argmin"] != k3 or la["suppression_matrix"] != nms
                    or la["greedy_keep"] != nms):
                raise SystemExit(f"({run}) rank {s['rank']} launched {la}, want K3 {k3}, "
                                 f"K1 and greedy {nms}")
    log(f"[dist d] launches per run and rank (K3 once per step, K1 and greedy once per eval "
        f"batch on each rank): {json.dumps(counts)}")
    spec = AssignmentSpec.from_config(cfg)
    tables = make_location_tables((CANVAS, CANVAS), spec, device="cuda")
    loader = DataLoader(cfg, records, BATCH, seed=max(cfg.SEED, 0),
                        pad_hw=pad_target_hw(cfg, train=True), process_index=0, process_count=2)
    batches = iter(loader)
    k3_err = 0.0
    for i in range(DIST_STEPS):
        g = to_device(next(batches), "cuda")
        if i == 0:
            k3_err = check_assign(spec, tables, g, "(b) rank 0 step 1", card)[5]
        else:
            k3_err = max(k3_err, assign_equal(spec, tables, g, f"(b) rank 0 step {i + 1}")[0])
    batches.close()
    emodel = build_model(cfg, device="cuda")
    Checkpointer(dir_b).resume_or_load(emodel, cfg, resume=True)
    val = get_dataset(val_set, cfg)
    nms_rows = []
    with torch.inference_mode():
        for i, batch in enumerate(DataLoader(cfg, val, BATCH, pad_hw=eval_pad_hw(cfg, val),
                                             train=False, process_index=0, process_count=2)):
            nms_rows.append(hold_nms(emodel(batch["image"].cuda()), DecodeSpec.from_config(cfg),
                                     f"(b) rank 0 eval batch {i}"))
    del emodel
    log(f"[dist d] rank 0's K3 inputs ({DIST_STEPS} batches of {BATCH // 2}) equal to the plain "
        f"version (max |min_area diff| {k3_err}), and its eval batches' NMS inputs (rows, valid, "
        f"kept) {nms_rows}: K1's bits and greedy's keep-set equal to their plain versions")

    # (e) NCCL with two ranks on one device: what NCCL says (not a pass condition)
    t0 = time.perf_counter()
    # --eval-only on no dataset: should NCCL accept the layout, the run ends
    # after the model is built
    res = wait_ranks(launch_ranks(args + ["DATASETS.TEST", "()"], os.path.join(root, "nccl_two"),
                                  2, flags=("--eval-only",), collectives=""),
                     timeout=NCCL_TRY_TIMEOUT_S)
    said = []
    for rc, text in res:
        lines = [ln.strip() for ln in text.splitlines()
                 if re.search(r"NCCL|Duplicate|nccl|Error", ln)]
        said.append({"exit": rc, "says": lines[-3:]})
    log(f"[dist e] NCCL with two ranks on the one card ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(said)[:2000]}")
    torch.cuda.empty_cache()
    log(f"[dist] phase 18 wall time {time.perf_counter() - t18:.1f} s [{card}]")
    runs = [sa] + sb + se + sc
    return {k: sum(s["launches"][k] for s in runs)
            for k in ("suppression_matrix", "greedy_keep", "assign_argmin")}


# ---- 17 (a). the train loop's run-time services ------------------------------

SERVICES_WINDOW = (1, 3)  # DEBUG.PROFILE_ITERS of the ablation run: steps 1 and 2
SERVICES_CKPT_PERIOD = 2  # its SOLVER.CHECKPOINT_PERIOD: saves at step 2 and at the end
CONV_KERNEL = re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|xmma", re.I)


def check_services(cfg, out_dir, hook_path, ckpt_stats, card):
    """The ablation CLI run's services: its profiler trace names K3 and a
    convolution kernel, DAFNE_NOTIFY_CMD got run_report.json (train_done),
    and its asynchronous saves' blocking and writer ms; then one save of
    the trained state synchronously and one asynchronously (files equal),
    their peak device memory over the state's and their ms."""
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.engine.optimizer import build_optimizer
    from dafne_torch.models import build_model

    trace = os.path.join(out_dir, "profile", "trace_{}-{}.json".format(*SERVICES_WINDOW))
    if not os.path.exists(trace):
        raise SystemExit(f"no profiler trace at {trace}: {os.listdir(out_dir)}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    k3 = sum(n for name, n in kernels.items() if "assign_argmin" in name)
    convs = sum(n for name, n in kernels.items() if CONV_KERNEL.search(name))
    if not k3 or not convs:
        raise SystemExit(f"the trace names K3 {k3} and convolution kernels {convs} times: "
                         f"{kernels.most_common(12)}")
    with open(os.path.join(out_dir, "run_report.json")) as f:
        report = json.load(f)
    with open(hook_path) as f:
        piped = json.load(f)
    if piped != report or report["status"] != "train_done":
        raise SystemExit(f"run_report.json {report} and DAFNE_NOTIFY_CMD's stdin {piped}")
    log(f"[services] DEBUG.PROFILE_ITERS {list(SERVICES_WINDOW)}: {os.path.basename(trace)} "
        f"({os.path.getsize(trace)} bytes, {sum(kernels.values())} kernel events; K3 "
        f"assign_argmin_kernel {k3} times, convolution kernels {convs}); DAFNE_NOTIFY_CMD got "
        f"run_report.json (status {report['status']}, experiment {report['experiment']}); "
        f"SOLVER.CHECKPOINT_PERIOD {SERVICES_CKPT_PERIOD}: per save the loop's blocking ms "
        f"{[round(x, 2) for x in ckpt_stats['blocking_ms']]} (snapshot and queue) beside the "
        f"writer thread's ms {[round(x, 1) for x in ckpt_stats['worker_ms']]} (wait, copy to "
        f"the host, write) [{card}]")

    model = build_model(cfg, device="cuda")
    optimizer, scheduler = build_optimizer(cfg, model)
    if Checkpointer(out_dir).restore(model, optimizer, scheduler) != ABL_STEPS:
        raise SystemExit("the ablation run's last checkpoint is not its last step")
    state_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    state_bytes += sum(t.numel() * t.element_size() for st in optimizer.state.values()
                       for t in st.values() if torch.is_tensor(t))
    ck = Checkpointer(os.path.join(out_dir, "save_modes"))
    peak, ms = {}, {}
    for mode in ("sync", "async"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if mode == "sync":
            ck.save(1, model, optimizer, scheduler)
        else:
            ck.save_async(2, model, optimizer, scheduler)
            ms["async_blocking"] = (time.perf_counter() - t0) * 1e3
            ck.wait()
            ms["async_writer"] = ck.worker_s[-1] * 1e3
        ms[mode] = (time.perf_counter() - t0) * 1e3
        peak[mode] = (torch.cuda.max_memory_allocated() - base) / 2**30
    a, s_ = (torch.load(os.path.join(ck.dir, f"model_{i:07d}.pth"), map_location="cpu",
                        weights_only=True) for i in (2, 1))
    same = all(torch.equal(a["model"][k], s_["model"][k]) for k in s_["model"])
    same &= all(torch.equal(a["optimizer"]["state"][i][k], v)
                for i, st in s_["optimizer"]["state"].items() for k, v in st.items())
    if not same:
        raise SystemExit("an asynchronous save differs from the synchronous one")
    log(f"[services] one save of the trained state ({state_bytes / 2**30:.3f} GiB of parameters, "
        f"buffers and SGD momentum): synchronous {ms['sync']:.1f} ms, peak device memory over "
        f"the state's {peak['sync']:.3f} GiB; asynchronous {ms['async_blocking']:.1f} ms "
        f"blocking, writer {ms['async_writer']:.1f} ms, {ms['async']:.1f} ms to wait(), peak "
        f"{peak['async']:.3f} GiB (the snapshot); the two files equal [{card}]")
    del model, optimizer
    torch.cuda.empty_cache()


# ---- 21. export and artifact serving ----------------------------------------

EXPORT_RECIPE = os.path.join("configs", "dota-1.0", "1024.yaml")
EXPORT_SEED = 21  # the torch seed of the exported model's random weights
EXPORT_REPS = 5  # requests per body through each server
EXPORT_MATCH_GATE = 0.99  # artifact mode's detections matched to live mode's, both ways
OP_REPS = 20  # CUDA-event timings of each op and launcher


def run_tool(args, what, timeout):
    """(stdout, seconds) of ``python -m <args>`` in a process of its own (the
    CLI's cuDNN settings); raises with its output when it fails."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=timeout)
    if res.returncode != 0:
        raise SystemExit(f"{what} exited {res.returncode}:\n{res.stdout[-2000:]}\n"
                         f"{res.stderr[-3000:]}")
    return res.stdout, time.perf_counter() - t0


def request_bodies(out_dir):
    """{name: body}: a 1024^2 synthetic scene as PNG and as .npy, a 600x900
    crop of another as .npy, and the 1280x720 and 77x53 JPEG fixtures."""
    from dafne_torch.data.synthetic import load_synthetic_gen

    scenes = [r["image"] for r in load_synthetic_gen("test", 2, hw=CANVAS, max_boxes=96)]
    png_path = os.path.join(out_dir, "scene0.png")
    write_png(png_path, np.ascontiguousarray(scenes[0][:, :, ::-1]), 2)
    bodies = {}
    with open(png_path, "rb") as f:
        bodies["scene0.png"] = f.read()
    for name, img in (("scene1.npy", scenes[1]),
                      ("crop600x900.npy", np.ascontiguousarray(scenes[0][200:800, 100:1000]))):
        buf = io.BytesIO()
        np.save(buf, img)
        bodies[name] = buf.getvalue()
    for name in ("text_1.jpg", "prog_420.jpg"):
        with open(os.path.join(ROOT, JPEG_FIXTURES, name), "rb") as f:
            bodies[name] = f.read()
    return bodies


def phase_export(card, bias_minus_2_checkpoint):
    """Phase 21: the DOTA-1.0 1024 recipe's eval step (seeded random weights,
    class bias -2) exported by ``python -m dafne_torch.tools.export_model``
    at batch 1 and replayed by ``--check``, each in a process of its own;
    ``python -m dafne_torch.tools.serve --artifact`` and live mode on the
    same checkpoint answering the same PNG, JPEG and .npy requests of
    several sizes (match_rate >= EXPORT_MATCH_GATE both ways, bit-equal
    lists counted; the artifact server's /healthz launches once per
    request); K1's bits and greedy's keep-set through ``torch.ops.dafne``
    against their plain versions on one request's NMS input, each op timed
    beside its direct launcher.  Returns ({kernel: the artifact server's
    launches}, {kernel: the op's ms})."""
    from dafne_torch.config import get_cfg
    from dafne_torch.data import image_io as IO
    from dafne_torch.engine.checkpoint import restore_for_inference
    from dafne_torch.engine.predictor import Predictor
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.postprocess import DecodeSpec

    t21 = time.perf_counter()
    out = os.path.join(ROOT, "output", "chip_smoke_export")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    recipe = os.path.join(ROOT, EXPORT_RECIPE)
    cfg = get_cfg()
    cfg.merge_from_file(recipe)
    cfg.OUTPUT_DIR = out
    torch.manual_seed(EXPORT_SEED)
    bias_minus_2_checkpoint(cfg, out)  # step 1

    # the live server starts with the export; --check and the artifact
    # server start together after it; each a process of its own
    bodies = request_bodies(out)
    servers, art = [], None
    try:
        with ThreadPoolExecutor(3) as pool:
            live = pool.submit(start_server, ["--config-file", recipe, "OUTPUT_DIR", out],
                               os.path.join(out, "serve_live.log"))
            try:
                stdout, export_s = run_tool(
                    ["dafne_torch.tools.export_model", "--config-file", recipe, "--batch", "1",
                     "OUTPUT_DIR", out], "export_model", 900)
                exported = json.loads(stdout.strip().splitlines()[-1])
                artifact = exported["artifact"]
                if (exported["ops"].get("suppression_bits") != 1
                        or exported["ops"].get("greedy_keep_bits") != 1
                        or exported["pad_hw"] != [CANVAS, CANVAS] or exported["device"] != "cuda"):
                    raise SystemExit(f"the exported program: {json.dumps(exported)}")
                check = pool.submit(run_tool, ["dafne_torch.tools.export_model", "--check",
                                               artifact], "export_model --check", 600)
                art = pool.submit(start_server, ["--artifact", artifact],
                                  os.path.join(out, "serve_artifact.log"))
                stdout, check_s = check.result()
            finally:
                servers = [f.result()[0] for f in (live, art)
                           if f is not None and f.exception() is None]
        _, live_port, _, live_start_s = live.result()
        _, art_port, _, art_start_s = art.result()
        if "replay OK" not in stdout:
            raise SystemExit(f"--check did not replay: {stdout[-2000:]}")
        log(f"[export] python -m dafne_torch.tools.export_model --config-file {EXPORT_RECIPE} "
            f"--batch 1 (R-50, FPN P3-P7, GN towers, 15 classes, bf16, {CANVAS}^2, NMS cap "
            f"{cfg.TPU.NMS_MAX_CANDIDATES}) in {export_s:.1f} s (process start, model build, "
            f"restore, torch.export, save; the live server starting meanwhile); artifact "
            f"{exported['bytes']} bytes; dafne:: call nodes {json.dumps(exported['ops'])}; --check "
            f"in {check_s:.1f} s (process start, load, one replay of zeros; the artifact server "
            f"starting meanwhile): {stdout.strip().splitlines()[-1]}; torch {torch.__version__} "
            f"[{card}]")
        for port in (art_port, live_port):
            status, health = http_call(port, "GET", "/healthz")
            if status != 200 or health["checkpoint_step"] != 1:
                raise SystemExit(f"/healthz: {status} {health}")
        request_ms = {"artifact": {}, "live": {}}
        matched, total, exact, n_dets = [0, 0], [0, 0], 0, 0
        for name, body in bodies.items():
            kind = name.rsplit(".", 1)[1]
            replies = {}
            for mode, port in (("artifact", art_port), ("live", live_port)):
                for _ in range(EXPORT_REPS):
                    t0 = time.perf_counter()
                    status, reply = http_call(port, "POST", "/detect", body)
                    request_ms[mode].setdefault(kind, []).append(
                        (time.perf_counter() - t0) * 1e3)
                    if status != 200:
                        raise SystemExit(f"POST {name} to {mode} mode: {status} {reply}")
                replies[mode] = reply["detections"]
            got, want = replies["artifact"], replies["live"]
            for i, (a, b) in enumerate(((got, want), (want, got))):
                m, t = match_rate({name: dets_arrays(a)}, {name: dets_arrays(b)})
                matched[i], total[i] = matched[i] + m, total[i] + t
            exact += got == want
            n_dets += len(want)
        status, health = http_call(art_port, "GET", "/healthz")
    finally:
        for server in servers:
            stop_server(server)
    rates = [m / max(t, 1) for m, t in zip(matched, total)]
    ms_by_kind = {mode: {k: round(statistics.median(v), 2) for k, v in kinds.items()}
                  for mode, kinds in request_ms.items()}
    served = len(bodies) * EXPORT_REPS + 1  # and the warm-up
    log(f"[export] artifact server up in {art_start_s:.1f} s (process start, op library, "
        f"torch.export.load, warm-up), live server in {live_start_s:.1f} s (process start, model "
        f"build, restore, warm-up); {len(bodies)} bodies x {EXPORT_REPS} each: request ms per body "
        f"kind, client's host clock, median {json.dumps(ms_by_kind)} (png: a {CANVAS}^2 scene; npy: "
        f"a {CANVAS}^2 scene and a 600x900 crop; jpg: a 1280x720 and a 77x53 fixture); {n_dets} "
        f"live detections; artifact matched {matched[0]}/{total[0]} of live's and live "
        f"{matched[1]}/{total[1]} of the artifact's (score within 1e-4, corners within 1e-2); "
        f"bit-equal lists {exact} of {len(bodies)}; the artifact server's launches "
        f"{json.dumps(health['launches'])} after {served} requests with the warm-up [{card}]")
    if n_dets == 0:
        raise SystemExit("the requests gave no detections to compare")
    if min(rates) < EXPORT_MATCH_GATE:
        raise SystemExit(f"artifact mode matched live mode at {rates}, under {EXPORT_MATCH_GATE}")
    if health["requests"] != served or set(health["launches"].values()) != {served}:
        raise SystemExit(f"the artifact server's /healthz after {served} requests: {health}")

    # K1 and greedy through torch.ops.dafne on one request's NMS input
    model, _ = restore_for_inference(cfg, "cuda")
    predictor = Predictor(model, cfg, batch=1)
    images, _ = predictor.canvas([IO.decode_image_bytes(bodies["scene0.png"])])
    spec = DecodeSpec.from_config(cfg)
    with torch.inference_mode():
        pc, pk, pv = nms_kernel_inputs(model(images), spec)
        thr = spec.nms_threshold
        bits = torch.ops.dafne.suppression_bits(pc, pk, thr, 1e-6)
        s_plain = K.suppression_matrix_plain(pc, pk, thr)
        words = int((bits != K.pack_suppression_bits(s_plain)).sum())
        keep = torch.ops.dafne.greedy_keep_bits(bits, pv)
        entries = int((keep != K.greedy_keep_plain(s_plain, pv)).sum())
        if words or entries:
            raise SystemExit(f"through torch.ops.dafne: K1 differs from its plain version on {words} "
                             f"words, greedy on {entries} entries")
        op_ms = {"suppression_matrix": cuda_ms(
                     lambda: torch.ops.dafne.suppression_bits(pc, pk, thr, 1e-6), reps=OP_REPS),
                 "greedy_keep": cuda_ms(lambda: torch.ops.dafne.greedy_keep_bits(bits, pv),
                                        reps=OP_REPS)}
        direct_ms = {"suppression_matrix": cuda_ms(
                         lambda: K.suppression_bits_cuda(pc, pk, thr), reps=OP_REPS),
                     "greedy_keep": cuda_ms(lambda: K.greedy_keep_bits_cuda(bits, pv),
                                            reps=OP_REPS)}
    log(f"[export] one request's NMS input {list(pk.shape)} ({int(pv.sum())} valid, "
        f"{int(keep.sum())} kept): through torch.ops.dafne K1's bits equal to the packed plain S and "
        f"greedy's keep-set to the plain walk; CUDA events, median of {OP_REPS}: op ms "
        f"{json.dumps({k: round(v, 4) for k, v in op_ms.items()})} beside the direct launcher's "
        f"{json.dumps({k: round(v, 4) for k, v in direct_ms.items()})} [{card}]")
    del model, predictor
    torch.cuda.empty_cache()
    log(f"[export] phase 21 wall time {time.perf_counter() - t21:.1f} s [{card}]")
    return {k: health["launches"][k] for k in ("suppression_matrix", "greedy_keep")}, op_ms


# ---- 22. int8 eval ----------------------------------------------------------

INT8_SEED = 22  # the torch seed of phase 22's model
INT8_STEPS = 3  # timed eval steps of each program in (b)
INT8_CALIB_BATCHES = 2  # calibration batches of 8 on the card
INT8_NARROW_MIN = 32  # EVAL_INT8_MIN_CHANNELS of the narrow card-against-CPU check
INT8_BODIES = ("scene0.png", "text_1.jpg")  # request bodies of (d)


def int8_site_inputs(step, images):
    """({key: (first input, module, calls)}, calls per forward) of every
    Int8Conv2d of `step`'s program in one forward of `images`; the key is
    (input shape, dtype, output channels, kernel, stride, padding,
    dilation, bias, mode)."""
    from dafne_torch.layers import quant as Q

    sites, calls = {}, [0]

    def hook(mod, args):
        x = args[0]
        key = (tuple(x.shape), str(x.dtype).split(".")[-1], mod.weight_q.shape[0],
               tuple(mod.weight_q.shape[1:3]), tuple(mod.stride), tuple(mod.padding),
               tuple(mod.dilation), mod.bias is not None, mod.mode)
        if key not in sites:
            sites[key] = [x.detach().clone(), mod, 0]
        sites[key][2] += 1
        calls[0] += 1

    handles = [m.register_forward_pre_hook(hook) for m in step.program.model.modules()
               if isinstance(m, Q.Int8Conv2d)]
    try:
        with torch.inference_mode():
            step.program.model(images)
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    return sites, calls[0]


def int8_site_args(x, mod):
    """(static scale, the conv's arguments after x_q and x_s) of one site."""
    from dafne_torch.ops.kernels import quant as QK

    scale = 0.0 if mod.act_amax is None else QK.static_act_scale(mod.act_amax)
    bias = None if mod.bias is None else mod.bias.float()
    return scale, (mod.weight_q, mod.weight_scale, bias, list(mod.stride), list(mod.padding),
                   list(mod.dilation), x.dtype)


@torch.inference_mode()
def check_int8_site(x, mod):
    """Raise unless quantize_act and int8_conv are bit-equal to their plain
    versions on this site's input."""
    from dafne_torch.ops.kernels import quant as QK

    scale, conv_args = int8_site_args(x, mod)
    xq, xs = QK.quantize_act_cuda(x, scale)
    pq, ps = QK.quantize_act_plain(x, scale)
    if not (torch.equal(xq, pq) and torch.equal(xs, ps)):
        raise SystemExit(f"quantize_act differs from its plain version at {list(x.shape)}: "
                         f"{int((xq != pq).sum())} values, scales {xs.tolist()} vs {ps.tolist()}")
    y = QK.int8_conv_cuda(xq, xs, *conv_args)
    yp = QK.int8_conv_plain(xq, xs, *conv_args)
    if not torch.equal(y, yp):
        raise SystemExit(f"int8_conv differs from its plain version at {list(x.shape)} -> "
                         f"{list(y.shape)}: max |diff| {(y.float() - yp.float()).abs().max():.6g}")


@torch.inference_mode()
def int8_times(x, mod, card, what):
    """{"quantize": {...}, "conv": {...}} of one site: the wrappers' CUDA
    events (median of OP_REPS), the kernels' device ms, the plain versions'
    ms, the bounds, and the yardsticks the port never calls (torch._int_mm
    on the same NHWC matrix for a 1x1 stride-1 site; the bf16 cuDNN conv of
    the same shape, the time int8 has to beat, not the same function)."""
    import torch.nn.functional as F
    from dafne_torch.ops.kernels import quant as QK

    scale, conv_args = int8_site_args(x, mod)
    wq, ws, bias, stride, padding, dilation, _ = conv_args
    n, c, h, w = x.shape
    o, kh, kw = wq.shape[:3]
    ho, wo = QK.conv_out_hw(h, w, kh, kw, stride, padding, dilation)
    xq, xs = QK.quantize_act_cuda(x, scale)
    q = {"ms": cuda_ms(lambda: QK.quantize_act_cuda(x, scale), reps=OP_REPS),
         "device_ms": device_ms(lambda: QK.quantize_act_cuda(x, scale), "quantize_act",
                                launches=1 if scale > 0 else 2),  # (dynamic: absmax, store)
         "plain_ms": cuda_ms(lambda: QK.quantize_act_plain(x, scale), reps=PLAIN_REPS, warmup=0),
         "bound_ms": QK.quantize_bytes(n, c, h, w, x.element_size()) / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None}
    ops = QK.conv_ops(n, c, o, kh, kw, ho, wo)
    nbytes = QK.conv_bytes(n, c, h, w, o, kh, kw, ho, wo, x.element_size(), bias is not None)
    bounds = {"operations": ops / INT8_OPS_PER_S * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    by = max(bounds, key=bounds.get)
    library_ms = None
    if (kh, kw) == (1, 1) and stride == [1, 1] and padding == [0, 0]:
        a2, b2 = xq.reshape(n * h * w, c), wq.reshape(o, c).t()
        library_ms = cuda_ms(lambda: torch._int_mm(a2, b2), reps=OP_REPS)
    wf = mod.weight_q.permute(0, 3, 1, 2).to(x.dtype).contiguous()
    bf = None if bias is None else bias.to(x.dtype)
    conv = {"ms": cuda_ms(lambda: QK.int8_conv_cuda(xq, xs, *conv_args), reps=OP_REPS),
            "device_ms": device_ms(lambda: QK.int8_conv_cuda(xq, xs, *conv_args), "int8_conv"),
            "plain_ms": cuda_ms(lambda: QK.int8_conv_plain(xq, xs, *conv_args), reps=PLAIN_REPS,
                                warmup=0),
            "bound_ms": bounds[by], "bound_by": by, "library_ms": library_ms,
            "bf16_conv_ms": cuda_ms(lambda: F.conv2d(x, wf, bf, stride, padding, dilation),
                                    reps=OP_REPS),
            "shape": [n, c, h, w, o, kh, stride[0]]}
    conv["tops"] = round(ops / (conv["ms"] * 1e-3) / 1e12, 1)
    log(f"[int8 {what}] x {list(x.shape)} {x.dtype} -> {o} channels, {kh}x{kw} stride {stride[0]} "
        f"({mod.mode} scale): quantize_act ms={q['ms']:.4f} device_ms={fmt_ms(q['device_ms'])} "
        f"plain_ms={q['plain_ms']:.3f} bound_ms={q['bound_ms']:.4f} (bytes: x read once, x_q "
        f"written once); int8_conv ms={conv['ms']:.4f} device_ms={fmt_ms(conv['device_ms'])} "
        f"({conv['tops']} int8 TOPS on the events) plain_ms={conv['plain_ms']:.2f} bound_ms="
        f"{conv['bound_ms']:.4f} ({by}: {ops / 1e9:.1f} G int8 ops at 1,979 TOPS "
        f"{bounds['operations']:.4f}, {nbytes / 1e6:.1f} MB at 3.35 TB/s {bounds['bytes']:.4f}); "
        f"yardsticks the port never calls: torch._int_mm on the same [M, C] x [C, O] matrix "
        f"{fmt_ms(library_ms)} (1x1 stride-1 sites only: s32 out, no epilogue), bf16 cuDNN conv of "
        f"the same shape {conv['bf16_conv_ms']:.4f} (the time int8 has to beat) [{card}]")
    return {"quantize": q, "conv": conv}


def phase_int8(card):
    """Phase 22: int8 eval (TPU.EVAL_INT8) on the DOTA-1.0 1024 recipe at full
    width.  (a) every distinct quantized site of one forward, dynamic (auto
    width 256) and static (auto width 64), its kernels bit-equal to the
    plain versions, timed at the P3 tower 3x3 and a res4 1x1; (b) the eval
    step in bf16, int8 dynamic and int8 static (scales from
    calibrate_act_scales on INT8_CALIB_BATCHES batches on the card): step
    and forward ms, sites, launches (the site calls of a forward times the
    forwards), peak memory; the narrow model on the card against the CPU;
    (c) the canary's checkpoint of phase 19 in bf16, int8 dynamic and int8
    static (``int8_canary.evaluate``, then ``tools/calibrate_int8.py`` and
    the CLI's int8 eval, in this process while (d)'s export and live server
    start); (d) the static int8 eval step exported at batch 1 and
    served from the artifact beside live int8 mode, answer lists bit-equal.
    Returns the two kernels' rows of the kernels line."""
    from dafne_torch.config import get_cfg
    from dafne_torch.data.synthetic import load_synthetic_gen
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.layers import quant as Q
    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import quant as QK

    t22 = time.perf_counter()
    b = BATCH
    out = os.path.join(ROOT, "output", "chip_smoke_int8_eval")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    recipe = os.path.join(ROOT, EXPORT_RECIPE)
    cfg = get_cfg()
    cfg.merge_from_file(recipe)
    cfg.merge_from_list(["TPU.EVAL_BATCH", str(b), "OUTPUT_DIR", out])
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(INT8_SEED))
    with torch.no_grad():
        model.head.cls_logits.bias.fill_(-2.0)
    model.eval()
    scenes = [r["image"] for r in load_synthetic_gen("test", (INT8_CALIB_BATCHES + 1) * b,
                                                      hw=CANVAS, max_boxes=96)]
    batches = [torch.from_numpy(np.stack(scenes[i * b:(i + 1) * b])).cuda()
               for i in range(INT8_CALIB_BATCHES + 1)]
    images = batches[-1]

    # (b, set-up) calibration on the card, then the three programs
    t0 = time.perf_counter()
    scales = Q.calibrate_act_scales(model, batches[:INT8_CALIB_BATCHES], min_channels=64)
    calib_s = time.perf_counter() - t0
    scales_path = os.path.join(out, "int8_scales.json")
    Q.save_act_scales(scales_path, scales)
    steps = {}
    for mode in ("bf16", "int8_dynamic", "int8_static"):
        c = copy.deepcopy(cfg)
        c.TPU.EVAL_INT8 = mode != "bf16"
        c.TPU.EVAL_INT8_SCALES = scales_path if mode == "int8_static" else ""
        steps[mode] = make_eval_step(model, c, (CANVAS, CANVAS))
    if (steps["int8_dynamic"].program.int8["min_channels"] != 256
            or steps["int8_static"].program.int8["min_channels"] != 64
            or steps["int8_static"].program.int8["static_sites"] != len(scales)):
        raise SystemExit(f"int8 programs: {[s.program.int8 for s in steps.values()]}")

    # (a) the kernels at every distinct site of the recipe
    phase_a = time.perf_counter()
    site_calls = {}
    checked = 0
    timed = {}
    for mode in ("int8_dynamic", "int8_static"):
        sites, site_calls[mode] = int8_site_inputs(steps[mode], images)
        for key, (x, mod, _) in sites.items():
            check_int8_site(x, mod)
            checked += 1
        if mode == "int8_dynamic":  # the largest 3x3 site (P3) and res4's largest 1x1
            timed["P3"] = max((v[:2] for k, v in sites.items() if k[3] == (3, 3)),
                              key=lambda v: v[0].numel())
            timed["res4_1x1"] = max(
                (v[:2] for k, v in sites.items()
                 if k[3] == (1, 1) and k[4] == (1, 1) and k[0][2] == CANVAS // 16),
                key=lambda v: v[0].numel())
        shapes = sorted({(k[0], k[2], k[3], k[4]) for k in sites})
        log(f"[int8 sites {mode}] {steps[mode].program.int8['sites']} "
            f"sites, {site_calls[mode]} calls per forward (the towers' convs once per level), "
            f"{len(sites)} distinct (input, conv) shapes, each quantize_act and int8_conv bit-equal "
            f"to its plain version: {json.dumps([[list(s), o, list(k), list(st)] for s, o, k, st in shapes])} "
            f"[{card}]")
        del sites
        torch.cuda.empty_cache()
    times = {what: int8_times(x, mod, card, what) for what, (x, mod) in timed.items()}
    del timed
    torch.cuda.empty_cache()
    phase_a = time.perf_counter() - phase_a

    # (b) the eval step at full width: bf16, int8 dynamic, int8 static
    path_launches = {}
    summary = {}
    for mode, step in steps.items():
        with torch.inference_mode():
            step(images)
            torch.cuda.synchronize()
            QK.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            step_ms = host_ms(lambda: step(images), reps=INT8_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = {"quantize_act": QK.quantize_act_cuda.launches,
                        "int8_conv": QK.int8_conv_cuda.launches}
            fwd_ms = host_ms(lambda: step.program.model(images), reps=INT8_STEPS)
        want = INT8_STEPS * site_calls.get(mode, 0)
        if set(launches.values()) != {want}:
            raise SystemExit(f"{mode}: launches {launches} in {INT8_STEPS} eval steps, not "
                             f"{site_calls.get(mode, 0)} site calls x {INT8_STEPS}")
        path_launches[mode] = launches
        summary[mode] = {"eval_step_ms": round(step_ms, 2), "forward_ms": round(fwd_ms, 2),
                         "sites": step.program.int8["sites"],
                         "site_calls_per_forward": site_calls.get(mode, 0),
                         "launches": launches, "peak_memory_gib": round(peak, 2)}
    log(f"[int8 eval] DOTA-1.0 1024 recipe (R-50, FPN P3-P7, GN towers, 15 classes, bf16, "
        f"{CANVAS}^2, batch {b}, seeded weights, class bias -2); calibration on "
        f"{INT8_CALIB_BATCHES} batches in {calib_s:.2f} s ({len(scales)} sites); host clock around "
        f"the step or the forward and a synchronize, median of {INT8_STEPS}: {json.dumps(summary)} "
        f"[{card}]")

    # the narrow float32 model, card against CPU
    ncfg = get_cfg()
    ncfg.merge_from_list(NARROW + ["TPU.NMS_MAX_CANDIDATES", "1024", "MODEL.DAFNE.POST_NMS_TOPK_TEST",
                                   "300", "TPU.EVAL_INT8", "True", "TPU.EVAL_INT8_MIN_CHANNELS",
                                   str(INT8_NARROW_MIN)])
    ref = build_model(ncfg, device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref.head.cls_logits.bias.fill_(-2.0)
    ref.eval()
    small = torch.from_numpy(np.stack([r["image"] for r in load_synthetic_gen("test", 2, hw=256)])
                             .astype(np.float32))
    nscales = os.path.join(out, "narrow_scales.json")
    Q.save_act_scales(nscales, Q.calibrate_act_scales(ref, [small], INT8_NARROW_MIN))
    narrow = {}
    for mode in ("dynamic", "static"):
        c = copy.deepcopy(ncfg)
        c.TPU.EVAL_INT8_SCALES = nscales if mode == "static" else ""
        cpu_step = make_eval_step(ref, c, (256, 256))
        card_step = make_eval_step(copy.deepcopy(ref).cuda(), c, (256, 256))
        # free running: each side's own float path into its int8 sites
        want = {k: v.numpy() for k, v in cpu_step(small).items()}
        got = {k: v.cpu().numpy() for k, v in card_step(small.cuda()).items()}
        free = match_rate(int8_preds(got), int8_preds(want))
        # forced: the card's int8 sites fed the CPU's inputs, call for call
        recorded = {}
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, name=name: recorded.setdefault(name, []).append(args[0].clone()))
            for name, m in cpu_step.program.model.named_modules() if isinstance(m, Q.Int8Conv2d)]
        want = {k: v.numpy() for k, v in cpu_step(small).items()}
        for h in hooks:
            h.remove()
        outputs = {}
        hooks = []
        for name, m in card_step.program.model.named_modules():
            if isinstance(m, Q.Int8Conv2d):
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, args, name=name: (recorded[name].pop(0).cuda(),)))
        got = {k: v.cpu().numpy() for k, v in card_step(small.cuda()).items()}
        for h in hooks:
            h.remove()
        forced = match_rate(int8_preds(got), int8_preds(want))
        back = match_rate(int8_preds(want), int8_preds(got))
        narrow[mode] = {"sites": card_step.program.int8["sites"], "free": free, "forced": forced,
                        "forced_back": back}
        if any(recorded.values()) or forced[1] < 100 or min(forced[0] / forced[1],
                                                            back[0] / max(back[1], 1)) < 0.99:
            raise SystemExit(f"narrow int8 {mode}, card against CPU on the CPU's site inputs: "
                             f"{narrow[mode]}")
    log(f"[int8 narrow] the narrow float32 R-50, 256^2, batch 2, EVAL_INT8_MIN_CHANNELS "
        f"{INT8_NARROW_MIN}: CPU detections matched on the card (score within 1e-4, corners within "
        f"1e-2) {json.dumps(narrow)}; forced: the card's int8 sites fed the CPU's inputs call for "
        f"call (the float layers between sites drift by ~1e-7, and a drifted value at a rounding "
        f"boundary flips its int8 value, which the next sites amplify: the free-running match "
        f"rate is int8's own noise, as on the CPU against JAX) [{card}]")

    # (d) the static int8 eval step exported at batch 1 and served beside
    # live int8 mode: the export and the live server start now, and (c)
    # runs in this process meanwhile (it measures mAPs, no times)
    Checkpointer(out).save(1, model)
    del model, steps, batches, images
    torch.cuda.empty_cache()
    int8_args = ["OUTPUT_DIR", out, "TPU.EVAL_INT8", "True", "TPU.EVAL_INT8_SCALES", scales_path]
    bodies = {k: v for k, v in request_bodies(out).items() if k in INT8_BODIES}
    servers = []
    try:
        with ThreadPoolExecutor(2) as pool:
            live = pool.submit(start_server, ["--config-file", recipe] + int8_args,
                               os.path.join(out, "serve_live.log"))
            export = pool.submit(run_tool, ["dafne_torch.tools.export_model", "--config-file",
                                            recipe, "--batch", "1"] + int8_args,
                                 "export_model (int8 static)", 900)
            art = None
            try:
                int8_canary_on_phase19(card, out)  # (c)
                stdout, export_s = export.result()
                exported = json.loads(stdout.strip().splitlines()[-1])
                art = pool.submit(start_server, ["--artifact", exported["artifact"]],
                                  os.path.join(out, "serve_artifact.log"))
            finally:
                servers = [f.result()[0] for f in (live, art)
                           if f is not None and f.exception() is None]
        _, live_port, _, live_start_s = live.result()
        _, art_port, _, art_start_s = art.result()
        x8 = exported["int8"]
        if (x8["mode"] != "static" or x8["sites"] != len(scales) or x8["scales"] != scales
                or exported["ops"].get("quantize_act") != site_calls["int8_static"]
                or exported["ops"].get("int8_conv") != site_calls["int8_static"]):
            raise SystemExit(f"the exported int8 program: ops {exported['ops']}, int8 "
                             f"{ {k: v for k, v in x8.items() if k != 'scales'} }")
        exact, n_dets, request_ms = 0, 0, {}
        for name, body in bodies.items():
            replies = {}
            for mode, port in (("artifact", art_port), ("live", live_port)):
                t0 = time.perf_counter()
                status, reply = http_call(port, "POST", "/detect", body)
                request_ms.setdefault(mode, {})[name] = round((time.perf_counter() - t0) * 1e3, 2)
                if status != 200:
                    raise SystemExit(f"POST {name} to {mode} int8 mode: {status} {reply}")
                replies[mode] = reply["detections"]
            exact += replies["artifact"] == replies["live"]
            n_dets += len(replies["live"])
        healths = {mode: http_call(port, "GET", "/healthz")[1]
                   for mode, port in (("artifact", art_port), ("live", live_port))}
    finally:
        for server in servers:
            stop_server(server)
    served = len(bodies) + 1  # and the warm-up
    calls = site_calls["int8_static"]
    for mode, health in healths.items():
        h8 = health["int8"]
        if (h8["mode"] != "static" or h8["sites"] != len(scales)
                or set(h8["launches"].values()) != {served * calls}):
            raise SystemExit(f"the {mode} int8 server's /healthz after {served} requests: {h8}")
    log(f"[int8 export] python -m dafne_torch.tools.export_model --batch 1 TPU.EVAL_INT8 True "
        f"TPU.EVAL_INT8_SCALES <(b)'s JSON> in {export_s:.1f} s: {exported['bytes']} bytes, "
        f"dafne:: call nodes {json.dumps(exported['ops'])}, int8 {x8['mode']} {x8['sites']} sites "
        f"(the scales' content in export_meta.json); artifact server up in {art_start_s:.1f} s, "
        f"live int8 server in {live_start_s:.1f} s; bodies {list(bodies)}: {n_dets} live "
        f"detections, bit-equal lists {exact} of {len(bodies)}; request ms (client's host clock, "
        f"one each) {json.dumps(request_ms)}; int8 launches per server "
        f"{json.dumps({m: h['int8']['launches'] for m, h in healths.items()})} after {served} "
        f"requests with the warm-up, {calls} site calls each [{card}]")
    if n_dets == 0 or exact != len(bodies):
        raise SystemExit(f"artifact int8 mode answered {exact} of {len(bodies)} bodies as live int8 "
                         f"mode ({n_dets} detections)")
    path_launches["export_serve_int8"] = dict(healths["artifact"]["int8"]["launches"])

    rows = []
    for name, part in (("quantize_act", "quantize"), ("int8_conv", "conv")):
        p3, res4 = times["P3"][part], times["res4_1x1"][part]
        by_path = {"eval_int8": (path_launches["int8_dynamic"][name]
                                 + path_launches["int8_static"][name]),
                   "export_serve_int8": path_launches["export_serve_int8"][name]}
        rows.append({
            "name": name, "route": "cuda", "source": "dafne_torch/csrc/int8_conv.cu",
            "replaces": ("dafne_tpu/layers/quant.py:60-101 (XLA; no Pallas kernel)"
                         if name == "quantize_act" else
                         "dafne_tpu/layers/quant.py:112-134 (XLA int8 conv; no Pallas kernel)"),
            "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": 0.0,
            **{k: p3[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
            **({"bf16_conv_ms": p3["bf16_conv_ms"]} if name == "int8_conv" else {}),
            "at": "P3 tower 3x3 [8, 256, 128, 128] bf16, dynamic scale",
            "res4_1x1": {k: v for k, v in res4.items() if k not in ("shape", "tops")},
        })
    log(f"[int8] phase 22 wall time {time.perf_counter() - t22:.1f} s ((a) {phase_a:.1f} s, "
        f"{checked} site shapes checked) [{card}]")
    return rows


def int8_canary_on_phase19(card, out):
    """Phase 22 (c): phase 19's canary checkpoint, if it is still at hand,
    through ``int8_canary.evaluate`` (bf16, int8 dynamic and int8 static,
    scales from 2 batches of its scenes), then through the entry points a
    user calls: ``tools/calibrate_int8.py`` on the same 2 batches, its
    scales held equal to evaluate's, and the CLI's --eval-only with
    TPU.EVAL_INT8 in both modes (static on the tool's scales), each mAP held
    equal to evaluate's.  All under the CLI's cuDNN settings.  The mAPs are
    printed for PERF.md; their drop under bf16 is not gated."""
    from dafne_torch.data import register_all_datasets
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.layers.quant import load_act_scales
    from dafne_torch.models import build_model
    from dafne_torch.tools import calibrate_int8, canary, int8_canary
    from dafne_torch.tools.train import main as cli_main

    syn_dir = os.path.join(ROOT, "output", "chip_smoke_synthetic")
    if not os.path.isfile(os.path.join(Checkpointer(syn_dir).dir, "last_checkpoint")):
        log(f"[int8 canary] phase 19's checkpoint is not at hand under {syn_dir}: not measured")
        return None
    t0 = time.perf_counter()
    cfg = int8_canary.recipe(["SOLVER.MAX_ITER", str(SYN_ITERS), "OUTPUT_DIR", syn_dir])
    register_all_datasets(cfg)
    syn_args = ["--config-file", os.path.join(ROOT, SYN_RECIPE), "DEBUG.OVERFIT_NUM_IMAGES",
                str(SYN_IMAGES), "SOLVER.MAX_ITER", str(SYN_ITERS), "DATASETS.TEST",
                "('synthetic_train',)", "OUTPUT_DIR", syn_dir]
    tool_scales = os.path.join(out, "canary_scales.json")
    with canary.cli_backend_flags():
        model = build_model(cfg, device="cuda")
        Checkpointer(syn_dir).restore(model)
        ev = int8_canary.evaluate(cfg, model.eval(), os.path.join(out, "canary"))
        del model
        calibrate_int8.main(["--num-batches", str(int8_canary.CALIB_BATCHES), "--output",
                             tool_scales] + syn_args)
        cli = {}
        for mode, extra in (("int8_dynamic", ["TPU.EVAL_INT8", "True"]),
                            ("int8_static", ["TPU.EVAL_INT8", "True", "TPU.EVAL_INT8_SCALES",
                                             tool_scales])):
            cli[mode] = float(cli_main(["--eval-only"] + syn_args + extra)
                              ["synthetic_train"]["mAP"])
    ev_scales = load_act_scales(os.path.join(out, "canary", "int8_scales.json"))
    if load_act_scales(tool_scales) != ev_scales:
        raise SystemExit(f"tools/calibrate_int8.py's scales on phase 19's checkpoint differ from "
                         f"int8_canary.evaluate's on the same {int8_canary.CALIB_BATCHES} batches")
    canary_maps = {m: round(float(ev[k]), 4) for m, k in (
        ("bf16", "bf16_mAP"), ("int8_dynamic", "int8_mAP"), ("int8_static", "int8_static_mAP"))}
    if {m: round(v, 4) for m, v in cli.items()} != {m: canary_maps[m] for m in cli}:
        raise SystemExit(f"the CLI's --eval-only int8 mAPs {cli} on phase 19's checkpoint are not "
                         f"int8_canary.evaluate's {canary_maps}")
    drop = {m: round(canary_maps["bf16"] - canary_maps[m], 4)
            for m in ("int8_dynamic", "int8_static")}
    log(f"[int8 canary] phase 19's checkpoint ({SYN_RECIPE}, {SYN_ITERS} steps) through "
        f"int8_canary.evaluate on its {SYN_IMAGES} scenes, mAP {json.dumps(canary_maps)} "
        f"({ev['calibrated_sites']} calibrated sites); int8 below bf16 by {json.dumps(drop)} "
        f"(JAX's gate, tools/int8_canary.py: at most {int8_canary.MAX_DROP}; a number for "
        f"PERF.md here, not a gate of this run); tools/calibrate_int8.py --num-batches "
        f"{int8_canary.CALIB_BATCHES}: {len(ev_scales)} scales equal to evaluate's; CLI "
        f"--eval-only TPU.EVAL_INT8 True, dynamic and static on the tool's scales: mAP "
        f"{json.dumps(cli)}, equal to evaluate's; (c) in {time.perf_counter() - t0:.1f} s [{card}]")
    return canary_maps


def int8_preds(det):
    """match_rate's {image: {classes, scores, corners}} of an eval step's
    valid detections (numpy)."""
    return {str(i): {k: det[k][i][det["valid"][i]] for k in ("classes", "scores", "corners")}
            for i in range(det["valid"].shape[0])}


# ---- 23. the trained-weight gates, short ------------------------------------

#: the JAX package's gate records at the repo root, never written by the port
JAX_GATE_RECORDS = ("INT8_CANARY.json", "TTA_CANARY.json", "GEN_CANARY.json",
                    "GEN_CANARY_1024.json")
#: what each port record adds to the JAX package's fields
GATE_ADDED_FIELDS = ("power_limit", "torch", "seed", "checks")
QK_NAMES = ("quantize_act", "int8_conv")  # the int8 kernels: no TTA gate path runs them
GATE_STEPS = 20  # train steps of the canaries and of gen_canary at 256
GATE_SCENES = 8  # DEBUG.OVERFIT_NUM_IMAGES: train (and, for gen_canary, val) scenes
GATE_1024_STEPS = 10  # train steps of gen_canary at 1024 (its 3 bucket canvases)
GATE_OPTS = {path: ["SOLVER.MAX_ITER", str(steps), "DEBUG.OVERFIT_NUM_IMAGES", str(GATE_SCENES)]
             for path, steps in (("gate_int8", GATE_STEPS), ("gate_tta", GATE_STEPS),
                                 ("gate_gen256", GATE_STEPS), ("gate_gen1024", GATE_1024_STEPS))}


def file_digests(names):
    """{name: SHA-256 of the file at the repo root, or None when absent}."""
    out = {}
    for name in names:
        path = os.path.join(ROOT, name)
        out[name] = (hashlib.sha256(open(path, "rb").read()).hexdigest()
                     if os.path.isfile(path) else None)
    return out


def phase_gates(card):
    """Phase 23: each gate tool's record function at full width and a cut
    depth (GATE_OPTS), its files under output/chip_smoke_gates.  Held: the
    fields (the JAX record's and GATE_ADDED_FIELDS), finite mAPs, val ids
    disjoint from the train ids and the calibration on train images only
    (gen_canary), image 0's TTA copies equal to build_tta_augs's count
    (tta_canary), the JAX package's records unchanged.  Not held: the gates'
    thresholds, which this depth cannot pass.  Returns {path: launches}."""
    from dafne_torch.engine.tta import build_tta_augs
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.kernels import quant as QK
    from dafne_torch.tools import gen_canary, int8_canary, tta_canary

    t23 = time.perf_counter()
    out = os.path.join(ROOT, "output", "chip_smoke_gates")
    shutil.rmtree(out, ignore_errors=True)
    records_before = file_digests(JAX_GATE_RECORDS)
    if None in records_before.values():
        raise SystemExit(f"a JAX package record is missing: {records_before}")
    gates = {  # path: (the JAX package's record, the record function)
        "gate_int8": ("INT8_CANARY.json", lambda o, st: int8_canary.run(o, "cuda", st)),
        "gate_tta": ("TTA_CANARY.json", lambda o, st: tta_canary.run(o, "cuda", st)),
        "gate_gen256": ("GEN_CANARY.json", lambda o, st: gen_canary.run(256, o, "cuda", None, st)),
        "gate_gen1024": ("GEN_CANARY_1024.json",
                         lambda o, st: gen_canary.run(1024, o, "cuda", None, st)),
    }
    launches = {}
    for path, (jax_record, fn) in gates.items():
        K.reset_launch_counts()
        A.reset_launch_counts()
        QK.reset_launch_counts()
        st = {}
        t0 = time.perf_counter()
        record = fn(GATE_OPTS[path] + ["OUTPUT_DIR", os.path.join(out, path)], st)
        wall = time.perf_counter() - t0
        launches[path] = {"suppression_matrix": K.suppression_bits_cuda.launches,
                          "greedy_keep": K.greedy_keep_bits_cuda.launches,
                          "assign_argmin": A.assign_argmin_cuda.launches,
                          "quantize_act": QK.quantize_act_cuda.launches,
                          "int8_conv": QK.int8_conv_cuda.launches}
        ran = [k for k in launches[path] if path != "gate_tta" or k not in QK_NAMES]
        if not all(launches[path][k] for k in ran):
            raise SystemExit(f"{path}: a kernel of its path never launched: {launches[path]}")
        with open(os.path.join(ROOT, jax_record)) as f:
            fields = list(json.load(f)) + list(GATE_ADDED_FIELDS)
        missing = [k for k in fields if k not in record]
        maps = {k: v for k, v in record.items() if k.endswith("mAP")}
        if missing or not maps or not all(np.isfinite(v) for v in maps.values()):
            raise SystemExit(f"{path}: fields missing {missing}, mAPs {maps}: {record}")
        if record["device"] != torch.cuda.get_device_name(0) or not record["power_limit"]:
            raise SystemExit(f"{path}: the record names no card: {record}")
        if path.startswith("gate_gen"):
            train, val, calib = set(st["train_ids"]), set(st["val_ids"]), set(st["calib_ids"])
            if train & val or not calib or not calib <= train:
                raise SystemExit(f"{path}: val ids shared with train {sorted(train & val)}, "
                                 f"calibration images {sorted(calib)} not all train images")
        if path == "gate_tta":
            (h, w), copies = st["img0_hw"], st["img0"]["copies"]
            want = len(build_tta_augs(tta_canary.recipe(GATE_OPTS[path]), w, h))
            if not record["tta_augs"] == copies == want:
                raise SystemExit(f"gate_tta: tta_augs {record['tta_augs']}, image 0's copies "
                                 f"{copies}, build_tta_augs {want}")
        log(f"[gates {path}] {record['iters']} steps in {wall:.1f} s: record "
            f"{json.dumps(record)}; launches {json.dumps(launches[path])}; ids: train "
            f"{len(st['train_ids'])}"
            + (f", val {len(st['val_ids'])} (disjoint), calibration {len(st['calib_ids'])} "
               f"(train images only)" if "val_ids" in st else "") + f" [{card}]")
    records_after = file_digests(JAX_GATE_RECORDS)
    if records_after != records_before:
        raise SystemExit(f"a JAX package record changed: {records_before} -> {records_after}")
    log(f"[gates] the JAX package's records byte-identical before and after "
        f"({', '.join(JAX_GATE_RECORDS)}); phase 23 wall time {time.perf_counter() - t23:.1f} s "
        f"[{card}]")
    return launches


# ---- 15. helpers: PNG files, a DOTA tree and Detectron2 checkpoints ----------

DOTA_10_CLASSES = [  # the DOTA-1.0 categories, in the devkit's id order
    "plane", "baseball-diamond", "bridge", "ground-track-field", "small-vehicle",
    "large-vehicle", "ship", "tennis-court", "basketball-court", "storage-tank",
    "soccer-ball-field", "roundabout", "harbor", "swimming-pool", "helicopter",
]


# phase 24: the measurement tools at full width, cut iterations
TOOL_PHASES = ["model_fwd", "assign_only", "eval_full", "nms_only", "suppression_only",
               "suppression_only_2d", "greedy_only", "decode_only", "train_step",
               "eval_roofline", "roofline"]
TOOL_ITERS, TOOL_WARMUP = 2, 1  # the profile's, the benchmark's and the ablation's
TOOL_PCT_MAX = 1.05  # a roofline share over this is a wrong bound or a wrong time
#: the JAX tools' record fields (tools/train_step_profile.py :683-701, :821-832;
#: tools/benchmark.py :158-285)
PROFILE_ROW_FIELDS = ("flops_g", "bytes_gb", "flops_bound_ms", "bw_bound_ms", "bound_ms", "bound",
                      "measured_ms", "pct_of_bound")
EVAL_ROW_FIELDS = ("measured_ms", "flops_g", "bytes_gb", "compute_unit", "compute_bound_ms",
                   "bw_bound_ms", "bound_ms", "pct_of_bound")
BENCH_FIELDS = {"eval": ("task", "img_per_s", "latency_ms", "pad_hw", "batch_size", "device"),
                "train": ("task", "img_per_s", "step_ms", "bucketed", "device_aug", "canvases",
                          "batch_size", "device")}


def phase_tools(card):
    """Phase 24: each measurement tool in this process at the DOTA-1.0 1024
    recipe's width with cut iterations (TOOL_ITERS), its records under
    output/chip_smoke_tools.  Returns {kernel: launches} of the four tools."""
    from argparse import Namespace

    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.tools import ablate_train_step, analyze_model, benchmark
    from dafne_torch.tools import train_step_profile as TSP

    t24 = time.perf_counter()
    out = os.path.join(ROOT, "output", "chip_smoke_tools")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    K.reset_launch_counts()
    A.reset_launch_counts()
    cfg = analyze_model.load_cfg("", DOTA_1024)
    t0 = time.perf_counter()
    rep = analyze_model.analyze(cfg, ["parameter", "flop"], "cuda", image_size=CANVAS)
    model = build_model(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    del model
    par = rep["parameter"]
    if (par["torch_parameters"] != n_params
            or par["total"] != par["torch_parameters"] + par["frozen_bn_buffers"]):
        raise SystemExit(f"analyze_model's parameters {par} against sum(p.numel()) {n_params}")
    log(f"[tools analyze_model] {par['total']:,} parameters (JAX's count: torch parameters "
        f"{n_params:,} = sum(p.numel()) + FrozenBN buffers {par['frozen_bn_buffers']:,}), "
        f"groups {par['groups']}; forward at 1024^2 batch 1: {rep['flop']['flops'] / 1e9:.1f} "
        f"GFLOP, {rep['flop']['bytes'] / 1e6:.1f} MB; {time.perf_counter() - t0:.1f} s [{card}]")

    t0 = time.perf_counter()
    prof = TSP.run(TOOL_PHASES, "cuda", batch=BATCH, hw=CANVAS, iters=TOOL_ITERS,
                   warmup=TOOL_WARMUP)
    path = os.path.join(out, "PROFILE_TRAIN_TORCH.json")
    TSP.write(prof, path, BATCH)
    with open(path) as f:
        prof = json.load(f)
    missing = [f"{p}_ms" for p in TOOL_PHASES if p not in ("eval_roofline", "roofline")
               and f"{p}_ms" not in prof]
    missing += [f"roofline.{k}.{f}" for k in ("model_fwd", "model_grad", "eval_full", "train_step")
                for f in PROFILE_ROW_FIELDS if f not in prof["roofline"].get(k, {})]
    missing += [f"eval_roofline.{k}.{f}" for k in ("model_fwd", "decode_topk", "nms")
                for f in EVAL_ROW_FIELDS if f not in prof["eval_roofline"].get(k, {})]
    if missing or not all(isinstance(prof["mfu"][k], float) for k in ("train_step", "eval_full")):
        raise SystemExit(f"train_step_profile's record lacks {missing} or an mfu: {prof['mfu']}")
    shares = {f"{t}.{k}": r["pct_of_bound"] for t in ("roofline", "eval_roofline")
              for k, r in prof[t].items() if r.get("pct_of_bound") is not None}
    if not shares or max(shares.values()) > TOOL_PCT_MAX:
        raise SystemExit(f"a roofline share over {TOOL_PCT_MAX}: {shares}")
    log(f"[tools train_step_profile] batch {BATCH} {CANVAS}^2, {TOOL_ITERS} iterations: "
        + ", ".join(f"{p} {prof[p + '_ms']:.2f} ms" for p in TOOL_PHASES if p + "_ms" in prof)
        + f"; mfu train_step {prof['mfu']['train_step']:.3f} eval_full "
        f"{prof['mfu']['eval_full']:.3f}; roofline shares {json.dumps(shares)}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")

    t0 = time.perf_counter()
    bench_opts = DOTA_1024 + ["DATASETS.TRAIN", "('synthetic_gen1024_train',)",
                              "DEBUG.OVERFIT_NUM_IMAGES", "16"]
    for task in ("eval", "train"):
        bcfg = analyze_model.load_cfg("", bench_opts)
        res = benchmark.run(bcfg, Namespace(task=task, iters=TOOL_ITERS, warmup=TOOL_WARMUP),
                            "cuda")
        json.loads(json.dumps(res))
        lacks = [f for f in BENCH_FIELDS[task] + ("mfu", "power_limit") if f not in res]
        if lacks or not isinstance(res["mfu"], float):
            raise SystemExit(f"benchmark {task} lacks {lacks} or its mfu: {res}")
        log(f"[tools benchmark {task}] {json.dumps(res)}")
    log(f"[tools benchmark] {time.perf_counter() - t0:.1f} s [{card}]")

    t0 = time.perf_counter()
    abl = ablate_train_step.run(list(ablate_train_step.VARIANTS), "cuda", batch=BATCH, hw=CANVAS,
                                iters=TOOL_ITERS, warmup=TOOL_WARMUP)
    TSP.write({"train_ablation_ms": abl["train_ablation_ms"]}, path, BATCH)
    with open(path) as f:
        if set(json.load(f)["train_ablation_ms"]) != set(ablate_train_step.VARIANTS):
            raise SystemExit("ablate_train_step's record lacks a variant")
    log(f"[tools ablate_train_step] {json.dumps(abl['train_ablation_ms'])}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")

    launches = {"suppression_matrix": K.suppression_bits_cuda.launches,
                "suppression_matrix_2d": K.suppression_bits_2d_cuda.launches,
                "greedy_keep": K.greedy_keep_bits_cuda.launches,
                "assign_argmin": A.assign_argmin_cuda.launches}
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the tools' path never launched: {launches}")
    log(f"[tools] launches {launches}; phase 24 wall time {time.perf_counter() - t24:.1f} s "
        f"[{card}]")
    torch.cuda.empty_cache()
    return launches


def start_server(args, log_path, timeout=240):
    """``python -m dafne_torch.tools.serve`` with `args` on a free port, as a
    process of its own (the CLI's cuDNN settings), its stderr in
    `log_path`.  Returns (process, port, its startup JSON line, seconds from
    the start to listening); raises when it does not start within
    `timeout`."""
    port = free_port()
    with open(log_path, "w") as err_f:
        server = subprocess.Popen(
            [sys.executable, "-m", "dafne_torch.tools.serve", "--port", str(port), *args],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=err_f, text=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        line = pool.submit(server.stdout.readline)
        try:
            startup = json.loads(line.result(timeout=timeout) or "null")
        except Exception:
            server.kill()
            startup = None
    if not startup:
        stop_server(server)
        with open(log_path) as f:
            raise SystemExit(f"the server did not start:\n{f.read()[-3000:]}")
    return server, port, startup, time.perf_counter() - t0


def stop_server(server):
    server.terminate()
    try:
        server.wait(timeout=30)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()


def http_call(port, method, path, body=None, timeout=300):
    """(status, JSON reply) of one request to the server on localhost."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def dets_arrays(dets):
    """A detection list as match_rate's per-image arrays."""
    return {"corners": np.asarray([d["corners"] for d in dets], np.float64).reshape(-1, 8),
            "scores": np.asarray([d["score"] for d in dets], np.float64),
            "classes": np.asarray([d["class"] for d in dets])}


def time_nms(head, spec, what, card):
    """``hold_nms`` on one decode's NMS input, then K1's and greedy's times
    there (CUDA events, median of 20) beside their plain versions and
    bounds, logged."""
    from dafne_torch.ops.kernels import quad_nms as K

    rows = hold_nms(head, spec, what)
    pc, pk, pv = nms_kernel_inputs(head, spec)
    thr = spec.nms_threshold
    bits = K.suppression_bits_cuda(pc, pk, thr)
    s_plain = K.suppression_matrix_plain(pc, pk, thr)
    keep = K.greedy_keep_bits_cuda(bits, pv)
    k1 = (cuda_ms(lambda: K.suppression_bits_cuda(pc, pk, thr)),
          cuda_ms(lambda: K.suppression_matrix_plain(pc, pk, thr), reps=PLAIN_REPS, warmup=0),
          *K.suppression_bound(pk, pk.shape[1])[0])
    g = (cuda_ms(lambda: K.greedy_keep_bits_cuda(bits, pv)),
         cuda_ms(lambda: K.greedy_keep_plain(s_plain, pv), reps=PLAIN_REPS, warmup=0),
         *K.greedy_bound(keep, pk.shape[1])[0])
    log(f"[K1/greedy {what}] NMS input {rows[0]} ({rows[1]} valid slots, {rows[2]} kept): K1 "
        f"bits equal to the packed plain S, greedy's keep-set to the plain walk; K1 "
        f"kernel_ms={k1[0]:.4f} plain_ms={k1[1]:.2f} bound_ms={k1[2]:.5f} ({k1[3]}); greedy "
        f"kernel_ms={g[0]:.4f} plain_ms={g[1]:.2f} bound_ms={g[2]:.5f} ({g[3]}) [{card}]")


def phase_jpeg_recipes(card, pkl, rpkl, hold_k3_on_loader, bias_minus_2_checkpoint):
    """Phase 19: (a) the committed JPEG fixtures decoded to cv2's hashes,
    the 1280x720 decode timed; (b) the synthetic canary recipe through the
    CLI (SYN_ITERS steps on SYN_IMAGES overfit scenes) and --eval-only,
    bf16 mAP over SYN_MAP_GATE; (c) ``python -m dafne_torch.tools.serve``
    on (b)'s checkpoint answering PNG, .npy and JPEG bodies as the
    in-process Predictor does, 400 for oversized and undecodable bodies;
    the ICDAR15 recipe from a tree of the 1280x720 fixtures (train, then
    --eval-only with its TTA ladder) and the R-101 recipe's eval batch.
    Returns {path: {kernel: launches}}."""
    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.data import image_io as IO
    from dafne_torch.data import jpeg as JPG
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import eval_pad_hw, pad_target_hw, train_canvas_buckets
    from dafne_torch.data.synthetic import load_synthetic
    from dafne_torch.engine import train_loop
    from dafne_torch.engine.checkpoint import Checkpointer
    from dafne_torch.engine.predictor import Predictor
    from dafne_torch.engine.trainer import make_location_tables
    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.postprocess import DecodeSpec
    from dafne_torch.ops.targets import AssignmentSpec
    from dafne_torch.tools.train import main as cli_main

    t19 = time.perf_counter()
    launches = {}

    def nms_launches():
        return {"suppression_matrix": K.suppression_bits_cuda.launches,
                "greedy_keep": K.greedy_keep_bits_cuda.launches}

    # (a) the committed fixtures, decoded on this host to cv2's pixels
    fixtures = os.path.join(ROOT, JPEG_FIXTURES)
    with open(os.path.join(fixtures, "fixtures.json")) as f:
        manifest = json.load(f)
    JPG.reset_launch_counts()
    t0 = time.perf_counter()
    for name, entry in manifest["files"].items():
        img = IO.read_image(os.path.join(fixtures, name))
        if (list(img.shape) != entry["shape"]
                or hashlib.sha256(img.tobytes()).hexdigest() != entry["sha256"]):
            raise SystemExit(f"JPEG fixture {name} ({entry['mode']}) decoded to other pixels "
                             f"than cv2.imread's")
    fixtures_s = time.perf_counter() - t0
    decode_ms = {}
    for name in ("text_1.jpg", "text_2.jpg", "text_3.jpg"):
        with open(os.path.join(fixtures, name), "rb") as f:
            data = f.read()
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            IO.decode_image_bytes(data)
            ms.append((time.perf_counter() - t0) * 1e3)
        decode_ms[f"{name} ({manifest['files'][name]['mode']})"] = round(statistics.median(ms), 2)
    log(f"[jpeg] {len(manifest['files'])} committed fixtures ({JPG.decode.launches} library "
        f"calls: baseline 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0, progressive, restart intervals, "
        f"optimized tables, gray, SOF1 with 16-bit tables, EXIF orientation 6, 1x1 and 7x13, "
        f"cut-off baseline and progressive streams, four 1280x720) decoded to the SHA-256 of "
        f"cv2.imread's pixels in {fixtures_s:.2f} s; decode of one 1280x720 JPEG from memory, "
        f"ms (host clock, median of 5): {json.dumps(decode_ms)} [{card}]")

    # (b) the synthetic canary recipe: train through the CLI, then --eval-only
    syn_dir = os.path.join(ROOT, "output", "chip_smoke_synthetic")
    shutil.rmtree(syn_dir, ignore_errors=True)
    syn_recipe = os.path.join(ROOT, SYN_RECIPE)
    syn_args = ["--config-file", syn_recipe, "DEBUG.OVERFIT_NUM_IMAGES", str(SYN_IMAGES),
                "SOLVER.MAX_ITER", str(SYN_ITERS), "DATASETS.TEST", "('synthetic_train',)",
                "OUTPUT_DIR", syn_dir]
    scfg = get_cfg()
    scfg.merge_from_file(syn_recipe)
    scfg.merge_from_list(syn_args[2:])
    # the CLI process's defaults: cuDNN picks its algorithms by heuristics,
    # so a seed gives one run, as in any `python -m dafne_torch.tools.train`.
    # Under phase 4's cudnn.benchmark it picks them by the clock, their
    # rounding changes from run to run, and 800 steps spread that into
    # mAPs on both sides of the gate (dafne_torch/tools/canary.py measures
    # both ways)
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = False, True
    A.reset_launch_counts()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syn_train = {}
    t0 = time.perf_counter()
    cli_main(syn_args, train_stats=syn_train)
    torch.cuda.synchronize()
    syn_train_s = time.perf_counter() - t0
    syn_k3 = A.assign_argmin_cuda.launches
    train_nms = nms_launches()
    ((canvas, st),) = syn_train["steps"].items()
    losses = st["loss"]
    n_eval_batches = -(-SYN_IMAGES // scfg.TPU.EVAL_BATCH)
    if syn_k3 != SYN_ITERS or len(losses) != SYN_ITERS or not np.isfinite(losses).all():
        raise SystemExit(f"synthetic train: K3 {syn_k3} for {SYN_ITERS} steps, "
                         f"{len(losses)} losses, finite {np.isfinite(losses).all()}")
    if set(train_nms.values()) != {n_eval_batches}:
        raise SystemExit(f"synthetic train's do_test: launches {train_nms} for {n_eval_batches} "
                         f"batches")
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    if not last < first:
        raise SystemExit(f"synthetic train: the loss did not fall ({first:.4f} -> {last:.4f})")
    syn_peak = torch.cuda.max_memory_allocated() / 2**30
    K.reset_launch_counts()
    syn_stats = {}
    t0 = time.perf_counter()
    res = cli_main(["--eval-only"] + syn_args, stats=syn_stats)
    syn_eval_s = time.perf_counter() - t0
    torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = flags
    eval_nms = nms_launches()
    syn_map = res["synthetic_train"]["mAP"]
    sst = syn_stats["synthetic_train"]
    if set(eval_nms.values()) != {n_eval_batches} or sst["images"] != SYN_IMAGES:
        raise SystemExit(f"synthetic eval: launches {eval_nms} for {n_eval_batches} batches, "
                         f"{sst['images']} images")
    if not syn_map > SYN_MAP_GATE:
        raise SystemExit(f"synthetic canary: bf16 mAP {syn_map:.2f} is not above the canary's "
                         f"gate {SYN_MAP_GATE}")
    log(f"[synthetic] CLI --config-file {SYN_RECIPE} (R-50 full width, 3 classes, bf16, batch "
        f"{scfg.SOLVER.IMS_PER_BATCH}, {canvas[0]}x{canvas[1]}, 90-degree rotations; the CLI's "
        f"cuDNN settings: heuristics, TF32 convs) with the "
        f"canary's overrides: {SYN_ITERS} steps on {SYN_IMAGES} overfit scenes in "
        f"{syn_train_s:.1f} s wall (model build, loader, steps, checkpoints, do_test); step ms on "
        f"CUDA events: first {st['ms'][0]:.1f}, median {statistics.median(st['ms'][1:]):.2f}; "
        f"total loss, mean of the first and last 20 steps {first:.4f} -> {last:.4f}; K3 {syn_k3} "
        f"launches (once per step); peak memory {syn_peak:.2f} GiB [{card}]")
    log(f"[synthetic] --eval-only on synthetic_train ({SYN_IMAGES} images, batch "
        f"{scfg.TPU.EVAL_BATCH}) in {syn_eval_s:.2f} s wall: eval loop "
        f"{sst['images'] / sst['loop_s']:.2f} img/s (host clock); bf16 mAP {syn_map:.2f} "
        f"(gate > {SYN_MAP_GATE}; the JAX package's canary recorded {JAX_CANARY_MAP} on its TPU, "
        f"INT8_CANARY.json); K1 and greedy {eval_nms} launches, once per batch [{card}]")
    # K3 and NMS held on the recipe's first train batch and first eval batch
    register_all_datasets(scfg)
    srecords = get_dataset("synthetic_train", scfg)
    err_k3, _ = hold_k3_on_loader(scfg, srecords, 1, "synthetic train")
    smodel = build_model(scfg, device="cuda")
    Checkpointer(syn_dir).resume_or_load(smodel, scfg, resume=True)
    smodel.eval()
    with torch.inference_mode():
        sbatch = next(iter(DataLoader(scfg, srecords, scfg.TPU.EVAL_BATCH,
                                      pad_hw=eval_pad_hw(scfg, srecords), train=False)))
        srows = hold_nms(smodel(sbatch["image"].cuda()), DecodeSpec.from_config(scfg),
                         "the synthetic eval batch")
    log(f"[synthetic] K3 equal to its plain version on the first train batch; K1 and greedy on "
        f"the first eval batch's NMS input (rows, valid, kept) {srows} [{card}]")
    launches["synthetic"] = {"assign_argmin": syn_k3,
                             "suppression_matrix": train_nms["suppression_matrix"]
                             + eval_nms["suppression_matrix"],
                             "greedy_keep": train_nms["greedy_keep"] + eval_nms["greedy_keep"]}

    # (c) the server on (b)'s checkpoint, as its own process
    server, port, startup, serve_start_s = start_server(
        ["--config-file", syn_recipe, "OUTPUT_DIR", syn_dir], os.path.join(syn_dir, "serve.log"))
    try:
        status, health = http_call(port, "GET", "/healthz")
        if status != 200 or not health["ok"] or health["checkpoint_step"] != SYN_ITERS:
            raise SystemExit(f"/healthz: {status} {health}")
        bodies = {}
        scenes = [r["image"] for r in load_synthetic("test", 2)]
        for k, img in enumerate(scenes):
            png_path = os.path.join(syn_dir, f"request{k}.png")
            write_png(png_path, np.ascontiguousarray(img[:, :, ::-1]), 2)
            with open(png_path, "rb") as f:
                bodies[f"scene{k}.png"] = f.read()
            buf = io.BytesIO()
            np.save(buf, img)
            bodies[f"scene{k}.npy"] = buf.getvalue()
        for name in ("text_1.jpg", "prog_420.jpg"):
            with open(os.path.join(fixtures, name), "rb") as f:
                bodies[name] = f.read()
        torch.backends.cudnn.benchmark = False  # the server process's default
        ref = Predictor(smodel, scfg, batch=1)
        request_ms, matched, total, exact = {}, 0, 0, 0
        for name, body in bodies.items():
            kind = name.rsplit(".", 1)[1]
            decoded = np.load(io.BytesIO(body)) if kind == "npy" else IO.decode_image_bytes(body)
            want = ref.detect([decoded])[0]
            for _ in range(SERVE_REPS):
                t0 = time.perf_counter()
                status, out = http_call(port, "POST", "/detect", body)
                request_ms.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise SystemExit(f"POST {name}: {status} {out}")
            got = out["detections"]
            m1, t1 = match_rate({name: dets_arrays(got)}, {name: dets_arrays(want)})
            m2, t2 = match_rate({name: dets_arrays(want)}, {name: dets_arrays(got)})
            if m1 != t1 or m2 != t2:
                raise SystemExit(f"POST {name}: the server matched {m1}/{t1} of Predictor.detect's "
                                 f"detections and Predictor {m2}/{t2} of the server's")
            matched, total, exact = matched + m1, total + t1, exact + (got == json.loads(json.dumps(want)))
        torch.backends.cudnn.benchmark = True
        if total == 0:
            raise SystemExit("the server's requests gave no detections to compare")
        refused = {}
        bomb = bytearray(bodies["prog_420.jpg"])
        sof = bytes(bomb).index(b"\xff\xc2")
        bomb[sof + 5:sof + 9] = struct.pack(">HH", 60000, 60000)
        for name, body in (("a 60000x60000 JPEG header", bytes(bomb)),
                           ("a cut-off PNG", bodies["scene0.png"][:100]), ("text", b"not an image")):
            status, out = http_call(port, "POST", "/detect", body)
            refused[name] = status
            if status != 400:
                raise SystemExit(f"POST {name}: {status} {out}, expected 400")
        status, health = http_call(port, "GET", "/healthz")
        served = len(bodies) * SERVE_REPS
        if health["requests"] != served + 1 or set(health["launches"].values()) != {served + 1}:
            raise SystemExit(f"/healthz after {served} requests and the warm-up: {health}")
    finally:
        stop_server(server)
    launches["serve"] = dict(health["launches"])
    ms_by_kind = {k: round(statistics.median(v), 2) for k, v in request_ms.items()}
    log(f"[serve] python -m dafne_torch.tools.serve on the {SYN_ITERS}-step checkpoint "
        f"(batch 1, canvas {startup['canvas']}): up in {serve_start_s:.1f} s (process start, "
        f"model, restore, warm-up); /healthz ok; {len(bodies)} bodies x {SERVE_REPS}: request ms "
        f"per body kind, client's host clock, median {json.dumps(ms_by_kind)} (png, npy: 256^2 "
        f"synthetic scenes; jpg: a 1280x720 and a 77x53 fixture); {total} detections, each "
        f"matched both ways to the in-process Predictor.detect on the same decoded image "
        f"(score within 1e-4, corners within 1e-2; {exact} of {len(bodies)} replies equal "
        f"exactly); 400 for {json.dumps(refused)}; the server's K1 and greedy launches "
        f"{health['launches']} (once per request and the warm-up) [{card}]")
    del smodel, ref

    # the ICDAR15 recipe on a tree of the 1280x720 fixtures
    icdar_dir = os.path.join(ROOT, "output", "chip_smoke_icdar")
    shutil.rmtree(icdar_dir, ignore_errors=True)
    os.environ["DAFNE_DATA_DIR"] = os.path.join(icdar_dir, "data")
    texts = []
    for name, lines in manifest["icdar"].items():
        with open(os.path.join(fixtures, name), "rb") as f:
            texts.append((f.read(), [(l["corners"], "###" if l["unreadable"] else f"word{k}")
                                     for k, l in enumerate(lines)]))
    write_icdar15_tree(os.path.join(icdar_dir, "data", "icdar-2015"),
                       {"train": texts[:2], "val": texts[2:3], "test": [texts[3], texts[0]]})
    icdar_recipe = os.path.join(ROOT, ICDAR_RECIPE)
    i_out = os.path.join(icdar_dir, "run")
    b = BATCH
    icdar_args = ["--config-file", icdar_recipe, "SOLVER.REFERENCE_WORLD_SIZE", "0",
                  "SOLVER.IMS_PER_BATCH", str(b), "TPU.EVAL_BATCH", str(b), "MODEL.WEIGHTS", pkl,
                  "OUTPUT_DIR", i_out]
    icfg = get_cfg()
    icfg.merge_from_file(icdar_recipe)
    icfg.merge_from_list(icdar_args[2:])
    register_all_datasets(icfg)
    irecords = get_dataset("icdar15_train", icfg) + get_dataset("icdar15_val", icfg)
    A.reset_launch_counts()
    JPG.reset_launch_counts()
    itrain = {}
    t0 = time.perf_counter()
    cli_main(icdar_args + ["SOLVER.MAX_ITER", str(ICDAR_STEPS), "DATASETS.TEST", "()"],
             train_stats=itrain)
    torch.cuda.synchronize()
    itrain_s = time.perf_counter() - t0
    icdar_k3 = A.assign_argmin_cuda.launches
    ilosses = [x for v in itrain["steps"].values() for x in v["loss"]]
    if icdar_k3 != ICDAR_STEPS or len(ilosses) != ICDAR_STEPS or not np.isfinite(ilosses).all():
        raise SystemExit(f"icdar15 train: K3 {icdar_k3} for {ICDAR_STEPS} steps, losses {ilosses}")
    icanvases = {f"{h}x{w}": [round(x, 1) for x in v["ms"]] for (h, w), v in itrain["steps"].items()}
    log(f"[icdar15] CLI --config-file {ICDAR_RECIPE} (R-50 from the R-50.pkl, 1 class, batch {b}) "
        f"on a tree of the four 1280x720 fixture JPEGs ({len(irecords)} train and val records, "
        f"'###' lines difficult, a 1-pixel line dropped): {ICDAR_STEPS} steps in {itrain_s:.1f} s "
        f"wall, step ms per canvas on CUDA events {json.dumps(icanvases)}, losses "
        f"{[round(x, 4) for x in ilosses]}; K3 {icdar_k3} launches; {JPG.decode.launches} JPEG "
        f"decodes on the loader's threads [{card}]")
    err_k3i, _ = hold_k3_on_loader(icfg, irecords, 1, "icdar15 train")
    # K3's time on the recipe's train canvas, on the loader's first batch
    ispec = AssignmentSpec.from_config(icfg)
    ibatch = next(iter(DataLoader(icfg, irecords, b, seed=max(icfg.SEED, 0),
                                  pad_hw=pad_target_hw(icfg, train=True),
                                  buckets=train_canvas_buckets(icfg, irecords))))
    ihw = train_loop.batch_canvas_hw(ibatch)
    check_assign(ispec, make_location_tables(ihw, ispec, device="cuda"),
                 train_loop.to_device(ibatch, "cuda"), f"icdar15 train canvas {ihw}", card)
    bias_minus_2_checkpoint(icfg, i_out)
    K.reset_launch_counts()
    istats, itta = {}, {}
    t0 = time.perf_counter()
    ires = cli_main(["--eval-only"] + icdar_args, stats=istats, tta_stats=itta)
    torch.cuda.synchronize()
    ieval_s = time.perf_counter() - t0
    i_nms = nms_launches()
    ist, itt = istats["icdar15_test"], itta["icdar15_test"]
    tta_steps = sum(sum(p["steps"].values()) for p in itt["per_image"])
    n_icdar_batches = -(-ist["images"] // b)
    copies = sorted({p["copies"] for p in itt["per_image"]})
    if (set(i_nms.values()) != {n_icdar_batches + tta_steps} or ist["images"] != 2
            or copies != [3 * len(icfg.TEST.AUG.MIN_SIZES)]):  # each size, hflip, vflip
        raise SystemExit(f"icdar15 eval: launches {i_nms} for {n_icdar_batches} batches and "
                         f"{tta_steps} TTA steps; {ist['images']} images, copies {copies}")
    imodel = build_model(icfg, device="cuda")
    Checkpointer(i_out).resume_or_load(imodel, icfg, resume=True)
    imodel.eval()
    itest = get_dataset("icdar15_test", icfg)
    ispec_d = DecodeSpec.from_config(icfg)
    for label, size in (("eval", icfg.INPUT.MIN_SIZE_TEST), ("TTA smallest",
                        min(icfg.TEST.AUG.MIN_SIZES)), ("TTA largest", max(icfg.TEST.AUG.MIN_SIZES))):
        vcfg = copy.deepcopy(icfg)
        vcfg.merge_from_list(["INPUT.MIN_SIZE_TEST", str(size), "INPUT.MAX_SIZE_TEST",
                              str(max(icfg.INPUT.MAX_SIZE_TEST, icfg.TEST.AUG.MAX_SIZE)
                                  if label != "eval" else icfg.INPUT.MAX_SIZE_TEST)])
        vpad = eval_pad_hw(vcfg, itest)
        with torch.inference_mode():
            vb = next(iter(DataLoader(vcfg, itest, b, pad_hw=vpad, train=False)))
            time_nms(imodel(vb["image"].cuda()), ispec_d, f"icdar15 {label} canvas {vpad}", card)
    del imodel
    itta_split = {"s_per_image": round(itt["loop_s"] / itt["images"], 3),
                  "wall_ms": [round(p["wall_ms"], 1) for p in itt["per_image"]],
                  "merge_ms": [round(p["merge_ms"], 1) for p in itt["per_image"]],
                  "eval_steps": itt["per_image"][0]["steps"],
                  "boxes_in": [p["boxes_in"] for p in itt["per_image"]],
                  "boxes_out": [p["boxes_out"] for p in itt["per_image"]]}
    log(f"[icdar15] --eval-only (class bias -2) on icdar15_test (2 fixture JPEGs, MIN_SIZE_TEST "
        f"{icfg.INPUT.MIN_SIZE_TEST}, MAX_SIZE_TEST {icfg.INPUT.MAX_SIZE_TEST}, "
        f"DETECTIONS_PER_IMAGE {icfg.TEST.DETECTIONS_PER_IMAGE}) in {ieval_s:.1f} s wall: mAP "
        f"{ires['icdar15_test']['mAP']:.4f}; TTA with the recipe's ladder "
        f"{list(icfg.TEST.AUG.MIN_SIZES)} (MAX_SIZE {icfg.TEST.AUG.MAX_SIZE}, FLIP: {copies} copies "
        f"per image) {json.dumps(itta_split)}, mAP {ires['tta']['icdar15_test']['mAP']:.4f}; K1 "
        f"and greedy {i_nms} launches, once per eval batch and TTA eval step [{card}]")
    launches["icdar15"] = {"assign_argmin": icdar_k3, **i_nms}

    # the R-101 recipe: one eval batch from an R-101.pkl
    r_out = os.path.join(icdar_dir, "r101")
    r_recipe = os.path.join(ROOT, ICDAR_R101_RECIPE)
    r_args = ["--eval-only", "--config-file", r_recipe, "TPU.EVAL_BATCH", str(b), "MODEL.WEIGHTS",
              rpkl, "TEST.AUG.ENABLED", "False", "OUTPUT_DIR", r_out]
    rcfg = get_cfg()
    rcfg.merge_from_file(r_recipe)
    rcfg.merge_from_list(r_args[3:])
    bias_minus_2_checkpoint(rcfg, r_out)  # the R-101.pkl backbone, a random head at bias -2
    K.reset_launch_counts()
    rstats = {}
    t0 = time.perf_counter()
    rres = cli_main(r_args, stats=rstats)
    r_s = time.perf_counter() - t0
    r_nms = nms_launches()
    if set(r_nms.values()) != {1} or rstats["icdar15_test"]["images"] != 2:
        raise SystemExit(f"icdar15 R-101 eval: launches {r_nms}, {rstats['icdar15_test']}")
    rmodel = build_model(rcfg, device="cuda")
    Checkpointer(r_out).resume_or_load(rmodel, rcfg, resume=True)
    rmodel.eval()
    with torch.inference_mode():
        rb = next(iter(DataLoader(rcfg, itest, b, pad_hw=eval_pad_hw(rcfg, itest), train=False)))
        rrows = hold_nms(rmodel(rb["image"].cuda()), DecodeSpec.from_config(rcfg),
                         "the icdar15 R-101 eval batch")
    del rmodel
    torch.cuda.empty_cache()
    log(f"[icdar15] CLI --eval-only --config-file {ICDAR_R101_RECIPE} (R-101 from the "
        f"R-101.pkl, a random head with class bias -2) on the 2 test JPEGs: one batch in {r_s:.1f} s wall, mAP "
        f"{rres['icdar15_test']['mAP']:.4f}; K1 and greedy {r_nms} launches, equal to their plain "
        f"versions on the batch's NMS input (rows, valid, kept) {rrows} [{card}]")
    launches["icdar15_r101"] = r_nms
    log(f"[phase 19] wall time {time.perf_counter() - t19:.1f} s; launches {json.dumps(launches)} "
        f"[{card}]")
    return launches


def deform_inputs(c, h, w, dtype, gen):
    """x [BATCH, c, h, w], offsets [BATCH, 18, h, w] f32 in +-DEFORM_OFFSET_PX
    and a mask [BATCH, 9, h, w] in (0, 1), drawn on the card from `gen`."""
    x = torch.randn((BATCH, c, h, w), generator=gen, device="cuda").to(dtype)
    off = (torch.rand((BATCH, 18, h, w), generator=gen, device="cuda") * 2 - 1) * DEFORM_OFFSET_PX
    mask = torch.rand((BATCH, 9, h, w), generator=gen, device="cuda").to(dtype)
    return x, off, mask


def grid_sample_grid(off, h, w):
    """The 9 taps' sampling positions of `off` as one grid_sample grid
    [N, 9h, w, 2] (align_corners=True coordinates), taps stacked on rows."""
    from dafne_torch.layers.deform_conv import TAPS

    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=off.device),
                            torch.arange(w, dtype=torch.float32, device=off.device),
                            indexing="ij")
    rows = []
    for k, (dy, dx) in enumerate(TAPS):
        px = gx + dx + off[:, 2 * k + 1]
        py = gy + dy + off[:, 2 * k]
        rows.append(torch.stack([px * (2.0 / (w - 1)) - 1, py * (2.0 / (h - 1)) - 1], -1))
    return torch.cat(rows, 1).contiguous()


def deform_bound(n, c, h, w, itemsize, mask, backward=False):
    """(bound ms, "bytes" or "operations") of one sampler call."""
    from dafne_torch.ops.kernels import deform_conv as DK

    if backward:
        nbytes = DK.backward_bytes(n, c, h, w, itemsize, mask)
        ops = DK.OPS_BACKWARD + (DK.OPS_BACKWARD_MASK if mask else 0)
    else:
        nbytes = DK.forward_bytes(n, c, h, w, itemsize, mask)
        ops = DK.OPS_FORWARD + (DK.OPS_FORWARD_MASK if mask else 0)
    return bound(ops * n * 9 * c * h * w, F32_OPS_NO_FMA, nbytes)


def deform_plain_grads(x, off, mask, g, dtype=None):
    """The plain version's autograd (grad x, grad offsets[, grad mask]) on
    one call's inputs (x, f32 offsets, mask or None) and incoming gradient
    g; with `dtype`, x, the mask and g cast to it first."""
    from dafne_torch.layers.deform_conv import deform_im2col_plain

    def cast(t):
        return t if dtype is None or t is None else t.to(dtype)

    leaves = [t.detach().clone().requires_grad_() for t in (cast(x), off, cast(mask))
              if t is not None]
    return torch.autograd.grad(deform_im2col_plain(*leaves), leaves, cast(g))


def grad_errs(got, want):
    """{gradient: (max |got - want|, max |want|)} over x, the offsets and
    the mask (where given)."""
    return {what: (float((a.float() - b_.float()).abs().max()), float(b_.float().abs().max()))
            for what, a, b_ in zip(("x", "offsets", "mask"), got, want)}


def deform_backward_err(x, off, mask, g):
    """grad_errs of the sampler's backward kernel against the plain
    version's autograd in the same dtype, on one call's inputs."""
    from dafne_torch.ops.kernels import deform_conv as DK

    return grad_errs(DK.deform_im2col_backward_cuda(x, off, mask, g),
                     deform_plain_grads(x, off, mask, g))


def deform_backward_held(errs, dtype, where):
    """Exit unless each gradient of `errs` (deform_backward_err) is within
    DEFORM_BWD_TOL[dtype] of its max |plain|; returns {gradient: the
    share of it}."""
    ratios = {}
    for what, (err, scale) in errs.items():
        if not err <= DEFORM_BWD_TOL[dtype] * scale:
            raise SystemExit(f"deform_im2col backward at {where} {dtype}: grad {what} max "
                             f"|diff| {err} over max |plain| {scale}, tolerance "
                             f"{DEFORM_BWD_TOL[dtype]} of it")
        ratios[what] = err / scale if scale else 0.0
    return ratios


def check_deform(card):
    """The sampler's kernels against the plain version at every shape of
    the deformable path (DEFORM_SHAPES, batch 8), in each of
    DEFORM_DTYPES, with and without a mask: the forward bit-equal, the
    backward within DEFORM_BWD_TOL of the plain version's autograd; then
    the times at P3 (the main path's largest call) beside the bound and
    grid_sample's.  Returns the kernels line's numbers {"forward": {...},
    "backward": {...}}."""
    import torch.nn.functional as F

    from dafne_torch.layers.deform_conv import deform_im2col_plain
    from dafne_torch.ops.kernels import deform_conv as DK

    gen = torch.Generator(device="cuda").manual_seed(20)
    compared = 0
    for name, (c, h, w) in DEFORM_SHAPES.items():
        for dtype in DEFORM_DTYPES:
            x, off, mask = deform_inputs(c, h, w, dtype, gen)
            for m in (None, mask):
                got = DK.deform_im2col_forward_cuda(x, off, m)
                want = deform_im2col_plain(x, off, m)
                if not torch.equal(got, want):
                    bad = int((got != want).sum())
                    raise SystemExit(f"deform_im2col differs from its plain version at {name} "
                                     f"{dtype} mask {m is not None}: {bad} of {got.numel()} "
                                     f"columns, max |diff| {float((got - want).abs().max())}")
                compared += got.numel()
                del got, want
    log(f"[deform] forward kernel bit-equal to deform_im2col_plain on {compared} columns: "
        f"{', '.join(f'{k} {v}' for k, v in DEFORM_SHAPES.items())} ([C, H, W], batch {BATCH}), "
        f"{', '.join(str(d)[6:] for d in DEFORM_DTYPES)}, with and without a mask, offsets in "
        f"+-{DEFORM_OFFSET_PX} px [{card}]")

    # the worst share of max |plain| per dtype, mask and gradient, and where
    bwd_worst, bwd_max = {}, 0.0
    for name, (c, h, w) in DEFORM_SHAPES.items():
        for dtype in DEFORM_DTYPES:
            x, off, mask = deform_inputs(c, h, w, dtype, gen)
            g = torch.randn((BATCH, 9 * c, h, w), generator=gen, device="cuda").to(dtype)
            for m in (None, mask):
                errs = deform_backward_err(x, off, m, g)
                ratios = deform_backward_held(errs, dtype, f"{name} mask {m is not None}")
                bwd_max = max([bwd_max] + [e for e, _ in errs.values()])
                key = f"{str(dtype)[6:]} {'mask' if m is not None else 'no mask'}"
                for what, r in ratios.items():
                    if r >= bwd_worst.setdefault(key, {}).get(what, (-1.0,))[0]:
                        bwd_worst[key][what] = (r, name)
            del x, off, mask, g
    log(f"[deform] backward kernel against the plain version's autograd at every shape above, "
        f"each dtype, with and without a mask (gradients of x, the offsets and the mask; the "
        f"worst max |diff| as a share of max |plain|, and its shape; tolerance "
        f"{json.dumps({str(k)[6:]: v for k, v in DEFORM_BWD_TOL.items()})}): "
        f"{json.dumps({k: {w: f'{r:.3g} at {n}' for w, (r, n) in v.items()} for k, v in bwd_worst.items()})} "
        f"[{card}]")

    # times at P3 in bf16, as the main path calls it (no mask)
    c, h, w = DEFORM_SHAPES["P3"]
    x, off, _ = deform_inputs(c, h, w, torch.bfloat16, gen)
    # grid_sample takes its grid in the input's dtype: bf16 coordinates
    # move the samples by up to ~0.25 px at P3, so it is a yardstick of
    # time only (the difference to the kernel is printed, not checked)
    grid = grid_sample_grid(off, h, w).to(x.dtype)
    cols = DK.deform_im2col_forward_cuda(x, off)
    lib = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    lib_err = float((lib.view(BATCH, c, 9, h, w).transpose(1, 2).reshape(cols.shape).float()
                     - cols.float()).abs().max())
    fwd = {"max_abs_err": 0.0,  # bit-equal, or the checks above exit
           "ms": cuda_ms(lambda: DK.deform_im2col_forward_cuda(x, off)),
           "device_ms": device_ms(lambda: DK.deform_im2col_forward_cuda(x, off),
                                  "deform_im2col_kernel"),
           "plain_ms": cuda_ms(lambda: deform_im2col_plain(x, off), reps=5, warmup=1),
           "library_ms": cuda_ms(lambda: F.grid_sample(x, grid, mode="bilinear",
                                                       padding_mode="zeros", align_corners=True))}
    fwd["bound_ms"], fwd["bound_by"] = deform_bound(BATCH, c, h, w, 2, False)
    g = torch.randn((BATCH, 9 * c, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    glib = lib.detach().clone().normal_()
    xs, os_ = x.detach().clone().requires_grad_(), off.detach().clone().requires_grad_()
    plain_cols = deform_im2col_plain(xs, os_)  # the graph once: the backward alone is timed
    bwd = {"max_abs_err": bwd_max,
           "ms": cuda_ms(lambda: DK.deform_im2col_backward_cuda(x, off, None, g)),
           "device_ms": device_ms(lambda: DK.deform_im2col_backward_cuda(x, off, None, g),
                                  "deform_im2col_backward_kernel"),
           "plain_ms": cuda_ms(lambda: torch.autograd.grad(plain_cols, (xs, os_), g,
                                                           retain_graph=True), reps=5, warmup=1),
           "library_ms": cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
               glib, x, grid, 0, 0, True, [True, True]))}
    bwd["bound_ms"], bwd["bound_by"] = deform_bound(BATCH, c, h, w, 2, False, backward=True)
    other = {}
    for name, (c2, h2, w2) in DEFORM_SHAPES.items():
        if name != "P3":
            x2, off2, _ = deform_inputs(c2, h2, w2, torch.bfloat16, gen)
            other[name] = round(cuda_ms(lambda: DK.deform_im2col_forward_cuda(x2, off2)), 4)
    log(f"[deform] P3 bf16 [{BATCH}, {c}, {h}, {w}], no mask (the main path's largest call): "
        f"forward kernel_ms={fwd['ms']:.4f} device_ms={fmt_ms(fwd['device_ms'])} "
        f"plain_ms={fwd['plain_ms']:.3f} grid_sample_ms={fwd['library_ms']:.4f} (the 9 taps in one "
        f"call, its grid in bf16; max |diff| to the kernel {lib_err:.3g}) bound_ms={fwd['bound_ms']:.4f} "
        f"({fwd['bound_by']}); backward kernel_ms={bwd['ms']:.4f} "
        f"device_ms={fmt_ms(bwd['device_ms'])} plain autograd_ms={bwd['plain_ms']:.3f} (its "
        f"backward alone, the graph built once) "
        f"grid_sampler_2d_backward_ms={bwd['library_ms']:.4f} bound_ms={bwd['bound_ms']:.4f} "
        f"({bwd['bound_by']}); forward kernel_ms at the other shapes {json.dumps(other)} [{card}]")
    del x, off, cols, lib, grid, g, glib, xs, os_, plain_cols
    torch.cuda.empty_cache()
    return {"forward": fwd, "backward": bwd}


def hold_deform_train_step(model, cfg, batch, hw, device_aug):
    """One train step of `model` (``make_train_step``: forward, backward,
    optimizer step) on `batch` at canvas `hw`, with the backward of every
    sampler call held on that call's own inputs (x, the model's offsets,
    its mask) and its own incoming gradient of the columns against the
    plain version's autograd in float32 on the same values, within
    DEFORM_BWD_TOL of x's dtype.  float32, not x's dtype: the model's
    gradients cancel over the channels, and the plain bfloat16 autograd
    rounds the sums of g * v01 and of g * v00 before it takes their
    difference for the offsets' gradient, where the kernel takes
    v01 - v00 first (6.2% of max |plain| apart at res4 on an H100 80GB
    HBM3 at 700 W); the
    plain version in x's dtype is measured against the same float32
    reference beside it, unchecked.  Returns (calls held, {gradient:
    (the worst max |diff| as a share of max |reference|, call)} for the
    kernel, the same for the plain version in x's dtype, the step's total
    loss, the tolerances applied by dtype)."""
    from dafne_torch.engine.optimizer import build_optimizer
    from dafne_torch.engine.trainer import make_train_step
    from dafne_torch.layers import deform_conv as DL
    from dafne_torch.ops.kernels import deform_conv as DK

    calls = []
    sampler = DL.deform_im2col

    def spy(x, offsets, mask=None):
        cols = sampler(x, offsets, mask)
        rec = {"x": x.detach().contiguous(), "offsets": offsets.detach().float().contiguous(),
               "mask": None if mask is None else mask.detach().contiguous()}
        cols.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous()))
        calls.append(rec)
        return cols

    optimizer, scheduler = build_optimizer(cfg, model)
    step = make_train_step(model, cfg, hw, optimizer, scheduler, device_aug=device_aug)
    DL.deform_im2col = spy
    try:
        loss = float(step(batch)["loss/total"])
    finally:
        DL.deform_im2col = sampler
    worst, plain_worst, tols = {}, {}, {}
    for i, rec in enumerate(calls):
        if "g" not in rec:
            raise SystemExit(f"sampler call {i} {tuple(rec['x'].shape)} had no gradient")
        args = (rec["x"], rec["offsets"], rec["mask"], rec["g"])
        dtype = rec["x"].dtype
        tols[str(dtype)[6:]] = DEFORM_BWD_TOL[dtype]
        where = f"train step call {i} {tuple(rec['x'].shape)} against float32"
        ref = deform_plain_grads(*args, dtype=torch.float32)
        for what, r in deform_backward_held(grad_errs(DK.deform_im2col_backward_cuda(*args), ref),
                                            dtype, where).items():
            if r >= worst.get(what, (-1.0,))[0]:
                worst[what] = (r, i)
        for what, (err, scale) in grad_errs(deform_plain_grads(*args), ref).items():
            r = err / scale if scale else 0.0
            if r >= plain_worst.get(what, (-1.0,))[0]:
                plain_worst[what] = (r, i)
        calls[i] = None
    if not np.isfinite(loss):
        raise SystemExit(f"deformable train step: total loss {loss}")
    return len(calls), worst, plain_worst, loss, tols


def phase_backbones(card, data_dir, pkl, train_cfg, train_records, hold_k3_on_loader,
                    bias_minus_2_checkpoint):
    """Phase 20: (a) the deformable sampler's kernels against the plain
    version (``check_deform``); (b) the DOTA-1.0 1024 recipe with the
    deformable-interval R-50 and deformable towers through the CLI:
    DEFORM_STEPS train steps from the R-50.pkl, then --eval-only on one
    batch (class bias -2), the sampler's kernels on every call of that
    batch against the plain version, one train step with the backward of
    every sampler call held (``hold_deform_train_step``), and the float32
    forward of one image
    on the card against the CPU; (c) each of FAMILY_CASES built on the card,
    FAMILY_STEPS train steps and one eval batch.  Returns (the kernels
    line's deform numbers, {path: {kernel: launches}})."""
    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.data.loader import DataLoader
    from dafne_torch.data.mapper import (DatasetMapper, eval_pad_hw, pad_target_hw,
                                         train_canvas_buckets)
    from dafne_torch.engine.inference import make_eval_step
    from dafne_torch.engine.optimizer import build_optimizer
    from dafne_torch.engine.train_loop import batch_canvas_hw, to_device
    from dafne_torch.engine.trainer import (make_location_tables, make_train_step,
                                            resolve_train_device_aug)
    from dafne_torch.layers.deform_conv import DeformConv2d, deform_im2col_plain
    from dafne_torch.models import build_model
    from dafne_torch.ops.kernels import assign as A
    from dafne_torch.ops.kernels import deform_conv as DK
    from dafne_torch.ops.kernels import quad_nms as K
    from dafne_torch.ops.postprocess import DecodeSpec
    from dafne_torch.ops.targets import AssignmentSpec
    from dafne_torch.tools.train import main as cli_main

    t20 = time.perf_counter()
    b = BATCH
    # the CLI's own cuDNN setting for the phase (benchmark off, as phase
    # 19b): under phase 4's benchmark the searches of the phase's first
    # steps took ~75 s on an H100 80GB HBM3 at 700 W
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    deform = check_deform(card)
    t_kernels = time.perf_counter() - t20

    def counts():
        return {"deform_im2col": DK.deform_im2col_forward_cuda.launches,
                "deform_im2col_backward": DK.deform_im2col_backward_cuda.launches,
                "assign_argmin": A.assign_argmin_cuda.launches,
                "suppression_matrix": K.suppression_bits_cuda.launches,
                "greedy_keep": K.greedy_keep_bits_cuda.launches}

    def reset():
        DK.reset_launch_counts()
        A.reset_launch_counts()
        K.reset_launch_counts()

    # (b) the deformable recipe through the CLI, on phase 15's DOTA tree
    os.environ["DAFNE_DATA_DIR"] = data_dir
    out_dir = os.path.join(ROOT, "output", "chip_smoke_deform")
    shutil.rmtree(out_dir, ignore_errors=True)
    recipe = os.path.join(ROOT, DEFORM_RECIPE)
    args = ["--config-file", recipe] + DEFORM_ARGS + [
        "SOLVER.REFERENCE_WORLD_SIZE", "0", "SOLVER.IMS_PER_BATCH", str(b), "TPU.EVAL_BATCH",
        str(b), "MODEL.WEIGHTS", pkl, "DATASETS.TRAIN", "('dota_1_train_1024',)",
        "DATASETS.TEST", "('dota_1_val_1024',)", "OUTPUT_DIR", out_dir]
    dcfg = get_cfg()
    dcfg.merge_from_file(recipe)
    dcfg.merge_from_list(args[2:])
    register_all_datasets(dcfg)
    probe = build_model(dcfg, device="cpu")
    n_trunk = sum(isinstance(m, DeformConv2d) for m in probe.backbone.modules())
    n_head = sum(isinstance(m, DeformConv2d) for m in probe.head.modules())
    per_forward = n_trunk + n_head * len(dcfg.MODEL.DAFNE.IN_FEATURES)
    del probe
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dtrain = {}
    t0 = time.perf_counter()
    cli_main(args + ["SOLVER.MAX_ITER", str(DEFORM_STEPS), "DATASETS.TEST", "()"],
             train_stats=dtrain)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    tc = counts()
    losses = [x for v in dtrain["steps"].values() for x in v["loss"]]
    step_ms = [x for v in dtrain["steps"].values() for x in v["ms"]]
    want_tc = {"deform_im2col": per_forward * DEFORM_STEPS,
               "deform_im2col_backward": per_forward * DEFORM_STEPS,
               "assign_argmin": DEFORM_STEPS, "suppression_matrix": 0, "greedy_keep": 0}
    if tc != want_tc or len(losses) != DEFORM_STEPS or not all(np.isfinite(losses)):
        raise SystemExit(f"deformable recipe train: launches {tc}, expected {want_tc}; losses "
                         f"{losses}")
    records = get_dataset("dota_1_train_1024", dcfg)
    k3_err, _ = hold_k3_on_loader(dcfg, records, DEFORM_STEPS, "deformable recipe train")
    log(f"[deform] CLI --config-file {DEFORM_RECIPE} {' '.join(DEFORM_ARGS)} (R-50 full width, "
        f"{n_trunk} deformable 3x3s in res3-res5, deformable last convs in {n_head} towers, "
        f"bf16, batch {b}, 1024^2): {DEFORM_STEPS} steps from the R-50.pkl in {train_s:.2f} s "
        f"wall, step ms (CUDA events) {[round(x, 2) for x in step_ms]}, total loss "
        f"{[round(x, 4) for x in losses]}, peak {train_peak:.2f} GiB; launches {json.dumps(tc)} "
        f"({per_forward} sampler calls a forward, each with its backward); K3 equal to its plain "
        f"version on each step's batch [{card}]")

    dmodel = bias_minus_2_checkpoint(dcfg, out_dir)
    reset()
    estats = {}
    eval_args = ["--eval-only"] + args + ["DEBUG.OVERFIT_NUM_IMAGES", str(b)]
    t0 = time.perf_counter()
    res = cli_main(eval_args, stats=estats)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    ec = counts()
    want_ec = {"deform_im2col": per_forward, "deform_im2col_backward": 0, "assign_argmin": 0,
               "suppression_matrix": 1, "greedy_keep": 1}
    dmap = res["dota_1_val_1024"].get("mAP")
    if ec != want_ec or estats["dota_1_val_1024"]["images"] != b or not np.isfinite(dmap):
        raise SystemExit(f"deformable recipe eval: launches {ec}, expected {want_ec}; mAP {dmap}")
    evcfg = copy.deepcopy(dcfg)
    evcfg.merge_from_list(eval_args[3:])
    val = get_dataset("dota_1_val_1024", evcfg)
    batch = next(iter(DataLoader(evcfg, val, b, pad_hw=eval_pad_hw(evcfg, val), train=False)))
    images = batch["image"].cuda()
    held = {"calls": 0, "columns": 0}

    def hold(module, inputs):
        x = inputs[0]
        off = module.offset_conv(x).float()
        got, want = DK.deform_im2col_forward_cuda(x, off), deform_im2col_plain(x, off)
        if not torch.equal(got, want):
            raise SystemExit(f"deform_im2col differs from its plain version on the eval batch's "
                             f"call {held['calls']} {tuple(x.shape)}")
        held["calls"] += 1
        held["columns"] += got.numel()

    hooks = [m.register_forward_pre_hook(hold) for m in dmodel.modules()
             if isinstance(m, DeformConv2d)]
    with torch.inference_mode():
        head = dmodel(images)
    for hk in hooks:
        hk.remove()
    rows = hold_nms(head, DecodeSpec.from_config(dcfg), "the deformable recipe's eval batch")
    if held["calls"] != per_forward:
        raise SystemExit(f"held {held['calls']} sampler calls of {per_forward}")
    log(f"[deform] CLI --eval-only (class bias -2) on {b} val tiles in {eval_s:.2f} s wall, mAP "
        f"{dmap:.4f}; launches {json.dumps(ec)}; on that batch every sampler call's columns "
        f"({held['calls']} calls, {held['columns']} columns, the model's own offsets) bit-equal "
        f"to the plain version, K1 and greedy equal to theirs (rows, valid, kept) {rows} [{card}]")

    state = {k: v.detach().cpu() for k, v in dmodel.state_dict().items()}
    del head

    # one train step of that model on the recipe loader's first batch, every
    # sampler call's backward held on the model's own offsets and gradients
    device_aug = resolve_train_device_aug(dcfg)
    tloader = DataLoader(dcfg, records, b, seed=max(dcfg.SEED, 0),
                         pad_hw=pad_target_hw(dcfg, train=True), device_aug=device_aug,
                         buckets=train_canvas_buckets(dcfg, records))
    tbatches = iter(tloader)
    tb = to_device(next(tbatches), "cuda")
    tbatches.close()
    thw = batch_canvas_hw(tb)
    n_held, bwd_worst, plain_worst, tloss, tols = hold_deform_train_step(dmodel, dcfg, tb, thw,
                                                                         device_aug)
    if n_held != per_forward:
        raise SystemExit(f"held the backward of {n_held} sampler calls of {per_forward}")

    def shares(worst):
        return json.dumps({k: f"{r:.3g} at call {i}" for k, (r, i) in worst.items()})

    log(f"[deform] one train step of that model (canvas {thw}, batch {b}, total loss {tloss:.4f}): "
        f"every sampler call's backward kernel ({n_held} calls, no mask, the model's own offsets "
        f"and incoming gradients) against the plain version's autograd in float32 on the same "
        f"values, the worst max |diff| as a share of max |reference| {shares(bwd_worst)} "
        f"(tolerance {json.dumps(tols)}); the plain version in bf16 against the same reference "
        f"{shares(plain_worst)} (not checked) [{card}]")
    del dmodel, tb
    torch.cuda.empty_cache()

    # one image in float32: the card against the CPU's plain path, same weights
    f32 = copy.deepcopy(dcfg)
    f32.TPU.COMPUTE_DTYPE = "float32"
    torch.cuda.empty_cache()
    card_model = build_model(f32, device="cuda")
    card_model.load_state_dict(state)
    cpu_model = build_model(f32, device="cpu")
    cpu_model.load_state_dict(state)
    one = images[:1]
    with torch.inference_mode():
        got = card_model(one)
        t0 = time.perf_counter()
        want = cpu_model(one.cpu())
        cpu_s = time.perf_counter() - t0
    worst = 0.0
    for key in ("logits", "corners", "center", "ctrness"):
        for lvl, (a, w_) in enumerate(zip(got[key], want[key])):
            rel = float((a.cpu() - w_).abs().max()) / max(float(w_.abs().max()), 1e-6)
            worst = max(worst, rel)
    if not worst <= DEFORM_CARD_CPU_TOL:
        raise SystemExit(f"the deformable model's f32 forward on the card differs from the CPU by "
                         f"{worst:.3g} of the output's max (tolerance {DEFORM_CARD_CPU_TOL})")
    log(f"[deform] one 1024^2 image in f32, the same weights: card (kernels) against the CPU "
        f"(plain sampler, {cpu_s:.1f} s): every output within {worst:.3g} of its max "
        f"(tolerance {DEFORM_CARD_CPU_TOL}) [{card}]")
    del card_model, cpu_model, got, want, state
    torch.cuda.empty_cache()
    launches = {"deform_train": tc, "deform_eval": ec}

    # (c) each other backbone family at full width: train steps, one eval batch
    fmapper = DatasetMapper(train_cfg, (CANVAS, CANVAS))
    fbatches = []
    for i in range(FAMILY_STEPS):
        ex = [fmapper(r, np.random.RandomState(200 + 8 * i + j))
              for j, r in enumerate(train_records[i * b:(i + 1) * b])]
        fb = gt_tensors(ex, "cuda")
        fb["image"] = torch.from_numpy(np.stack([e["image"] for e in ex])).cuda()
        fbatches.append(fb)
    rows_by = {}
    fam = {"assign_argmin": 0, "suppression_matrix": 0, "greedy_keep": 0}
    for name, extra in FAMILY_CASES:
        fcfg = copy.deepcopy(train_cfg)
        fcfg.merge_from_list(extra)
        t0 = time.perf_counter()
        fmodel = build_model(fcfg, device="cuda", generator=torch.Generator().manual_seed(20))
        optimizer, scheduler = build_optimizer(fcfg, fmodel)
        fstep = make_train_step(fmodel, fcfg, (CANVAS, CANVAS), optimizer, scheduler)
        fspec = AssignmentSpec.from_config(fcfg)
        ftables = make_location_tables((CANVAS, CANVAS), fspec, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms, losses = [], []
        for fb in fbatches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = fstep(fb)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t1) * 1e3, 2))
            losses.append(round(float(metrics["loss/total"]), 4))
        peak = torch.cuda.max_memory_allocated() / 2**30
        k3 = A.assign_argmin_cuda.launches
        for i, fb in enumerate(fbatches):
            assign_equal(fspec, ftables, fb, f"{name} step {i}")
        if k3 != FAMILY_STEPS or not all(np.isfinite(losses)):
            raise SystemExit(f"{name}: K3 {k3} for {FAMILY_STEPS} steps, losses {losses}")
        with torch.no_grad():
            fmodel.head.cls_logits.bias.fill_(-2.0)
        estep = make_eval_step(fmodel, fcfg, (CANVAS, CANVAS))
        K.reset_launch_counts()
        det = estep(fbatches[0]["image"])
        torch.cuda.synchronize()
        nms = (K.suppression_bits_cuda.launches, K.greedy_keep_bits_cuda.launches)
        if nms != (1, 1) or not torch.isfinite(det["corners"]).all():
            raise SystemExit(f"{name}: eval batch launches {nms}")
        with torch.inference_mode():
            rows_by[name] = hold_nms(fmodel(fbatches[0]["image"]), DecodeSpec.from_config(fcfg),
                                     f"{name} eval batch")
        n_params = sum(p.numel() for p in fmodel.parameters())
        log(f"[backbones] {name} ({' '.join(extra)}; {n_params / 1e6:.1f} M parameters, bf16, "
            f"batch {b}, 1024^2): {FAMILY_STEPS} train steps, step ms (host clock, synchronised; "
            f"the first holds the first call's set-up) {ms}, total loss {losses}, peak "
            f"{peak:.2f} GiB; K3 {k3} launches, equal to its plain version on each step's batch; one eval batch "
            f"(class bias -2): K1 and greedy once each, equal to their plain versions (rows, "
            f"valid, kept) {rows_by[name]}; {time.perf_counter() - t0:.2f} s wall with the "
            f"build [{card}]")
        fam["assign_argmin"] += k3
        fam["suppression_matrix"] += nms[0]
        fam["greedy_keep"] += nms[1]
        del fmodel, optimizer, scheduler, fstep, estep, det
        torch.cuda.empty_cache()
    del fbatches
    torch.backends.cudnn.benchmark = benchmark
    launches["backbones"] = fam
    log(f"[phase 20] wall time {time.perf_counter() - t20:.1f} s (kernel checks "
        f"{t_kernels:.1f} s); launches {json.dumps(launches)} [{card}]")
    return deform, launches


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


def write_bmp(path, bgr):
    """Write a BGR image [H, W, 3] uint8 as a 24-bit bottom-up BMP (rows
    padded to 4 bytes), as the HRSC2016 images are stored."""
    h, w, _ = bgr.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = bgr[::-1].reshape(h, 3 * w)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + rows.tobytes())


# HRSC2016 image sizes (width, height): non-square, within the dataset's
# range of about 300 x 300 to 1500 x 900
HRSC_SIZES = ((1166, 753), (1280, 800), (1000, 667), (500, 333), (933, 624), (1500, 900))


def ship_corners(cx, cy, w, h, angle):
    """An HRSC mbox (center, size, angle in radians) as [4, 2] corners,
    ``data/datasets/hrsc2016.py::xywha_to_corners``."""
    base = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    rot = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]])
    return base @ rot.T + [cx, cy]


def draw_ships(w, h, n, rng):
    """A sea of noise with `n` ships drawn as filled rotated rectangles:
    (BGR image [h, w, 3] uint8, [(cx, cy, sw, sh, angle)])."""
    img = np.empty((h, w, 3), np.uint8)
    img[...] = rng.randint(60, 110, 3)
    img += rng.randint(0, 24, (h, w, 1)).astype(np.uint8)
    ships = []
    for _ in range(n):
        sw = rng.uniform(0.08, 0.3) * min(w, h) * 2
        sh = sw / rng.uniform(3, 6)
        cx, cy = rng.uniform(0.15, 0.85) * w, rng.uniform(0.15, 0.85) * h
        a = rng.uniform(-np.pi / 2, np.pi / 2)
        c = ship_corners(cx, cy, sw, sh, a)
        x0, y0 = np.maximum(np.floor(c.min(0)).astype(int), 0)
        x1, y1 = np.minimum(np.ceil(c.max(0)).astype(int), [w, h])
        ys, xs = np.mgrid[y0:y1, x0:x1] + 0.5
        inside = np.ones(xs.shape, bool)
        for k in range(4):  # the same side of every edge (corners run clockwise)
            (ax, ay), (bx, by) = c[k], c[(k + 1) % 4]
            inside &= (bx - ax) * (ys - ay) - (by - ay) * (xs - ax) >= 0
        img[y0:y1, x0:x1][inside] = rng.randint(150, 256, 3)
        ships.append((cx, cy, sw, sh, a))
    return img, ships


def write_hrsc_tree(root, splits, rng, sizes=HRSC_SIZES, ships=(2, 6)):
    """Write an HRSC2016 tree in the layout ``data/datasets/hrsc2016.py``
    reads: ImageSets/<split>.txt, labelXml/<id>.xml and images/<id>.bmp
    (24-bit).  `splits` maps a split name to its number of images; image n
    takes size sizes[n % len(sizes)] and a random number of ships in
    `ships`, and every fourth image also a planted degenerate pair the
    eval mapper must drop: a point and an axis-aligned segment.  Returns
    {"expected": {bmp path: BGR array}, "ids": {split: [ids]}, "planted":
    {id: objects the eval mapper drops}}."""
    for d in ("ImageSets", "labelXml", "images"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    expected, ids, planted = {}, {}, {}
    n = 0
    for split, count in splits.items():
        ids[split] = []
        for _ in range(count):
            img_id = 100000001 + n
            w, h = sizes[n % len(sizes)]
            img, objs = draw_ships(w, h, rng.randint(ships[0], ships[1] + 1), rng)
            if n % 4 == 0:
                objs = objs + [(w / 2, h / 2, 0.0, 0.0, 0.3), (w / 3, h / 3, 0.0, 40.0, 0.0)]
                planted[img_id] = 2
            path = os.path.join(root, "images", f"{img_id}.bmp")
            write_bmp(path, img)
            expected[path] = img
            xml = "".join(
                "<HRSC_Object>" + "".join(f"<{k}>{v:.4f}</{k}>" for k, v in zip(
                    ("mbox_cx", "mbox_cy", "mbox_w", "mbox_h", "mbox_ang"), o))
                + "<difficult>0</difficult></HRSC_Object>" for o in objs)
            with open(os.path.join(root, "labelXml", f"{img_id}.xml"), "w") as f:
                f.write(f"<HRSC_Image><Img_ID>{img_id}</Img_ID><Img_SizeWidth>{w}"
                        f"</Img_SizeWidth><Img_SizeHeight>{h}</Img_SizeHeight>"
                        f"<HRSC_Objects>{xml}</HRSC_Objects></HRSC_Image>")
            ids[split].append(img_id)
            n += 1
        with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("\n".join(str(i) for i in ids[split]) + "\n")
    return {"expected": expected, "ids": ids, "planted": planted}


def write_icdar15_tree(root, splits):
    """Write an ICDAR-2015 tree in the layout ``data/datasets/icdar15.py``
    reads: ImageSets/<split>.txt ("gt_img_<id>" lines),
    images/<folder>/img_<id>.jpg and Annotations/<folder>/gt_img_<id>.txt
    (UTF-8 with a byte-order mark, one "x0,y0,...,x3,y3,text" line per
    word, "###" for an unreadable one), val in the train folder as in the
    dataset.  `splits` maps "train", "val" and "test" to lists of (JPEG
    bytes, [(8 corners, text)]); every image also gets a line 1 pixel wide,
    which the loader's validity filter drops.  Returns {split: [ids]}."""
    ids, n = {}, 0
    for split, images in splits.items():
        folder = "test" if split == "test" else "train"
        for d in ("images", "Annotations"):
            os.makedirs(os.path.join(root, d, folder), exist_ok=True)
        ids[split] = []
        for data, words in images:
            n += 1
            with open(os.path.join(root, "images", folder, f"img_{n}.jpg"), "wb") as f:
                f.write(data)
            lines = [",".join(str(int(round(v))) for v in corners) + "," + text
                     for corners, text in words] + ["10,10,11,10,11,50,10,50,|"]
            with open(os.path.join(root, "Annotations", folder, f"gt_img_{n}.txt"), "w",
                      encoding="utf-8-sig") as f:
                f.write("\r\n".join(lines) + "\r\n")
            ids[split].append(n)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    for split, split_ids in ids.items():
        with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("".join(f"gt_img_{i}\n" for i in split_ids))
    return ids


class WarpRecorder:
    """While entered, every call of the host warp library
    (``data/image_warp.py``: ``resize_linear``, ``warp_affine_linear``) is
    kept with its input, its arguments, its output and its host-clock ms on
    the calling thread (the loader's threads included); ``check`` holds
    each output against the plain NumPy version."""

    def __init__(self, iw):
        self.iw = iw
        self.calls = []
        self.orig = (iw.resize_linear, iw.warp_affine_linear)

    def __enter__(self):
        resize, warp = self.orig

        def rec(kind, fn, img, *args):
            t0 = time.perf_counter()
            out = fn(img, *args)
            self.calls.append((kind, img, args, out, (time.perf_counter() - t0) * 1e3))
            return out

        self.iw.resize_linear = lambda img, w, h: rec("resize", resize, img, w, h)
        self.iw.warp_affine_linear = lambda img, m, w, h: rec(
            "warp", warp, img, np.array(m, np.float32), w, h)
        return self

    def __exit__(self, *exc):
        self.iw.resize_linear, self.iw.warp_affine_linear = self.orig

    def ms(self, kind):
        return [c[4] for c in self.calls if c[0] == kind]

    def check(self, what, threads=8):
        """Exit unless every kept output equals the plain version's; then
        forget the calls.  Returns {kind: calls checked} and the seconds."""
        t0 = time.perf_counter()

        def same(call):
            kind, img, args, out, _ = call
            plain = (self.iw.resize_linear_plain if kind == "resize"
                     else self.iw.warp_affine_linear_plain)
            return np.array_equal(out, plain(img, *args))

        with ThreadPoolExecutor(threads) as pool:
            ok = list(pool.map(same, self.calls))
        if not all(ok):
            bad = [c[:1] + (c[1].shape, c[2][-2:]) for c, g in zip(self.calls, ok) if not g]
            raise SystemExit(f"{what}: the warp library differs from its plain version on {bad}")
        counts = {k: sum(c[0] == k for c in self.calls) for k in ("resize", "warp")}
        self.calls = []
        return counts, time.perf_counter() - t0


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


def write_msra_pickle(values, path):
    """An MSRA-style ImageNet pickle (``R-50.pkl``, ``R-101.pkl``) of the
    backbone's `values`: numpy under Caffe2 names, with the classifier the
    importer skips."""
    blobs = {c2_name(n): v for n, v in values.items() if c2_name(n)}
    blobs["fc1000_w"] = np.zeros((1000, 2048), np.float32)
    blobs["fc1000_b"] = np.zeros(1000, np.float32)
    with open(path, "wb") as f:
        pickle.dump(blobs, f)
    return path


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
    return write_msra_pickle(values, os.path.join(out_dir, "R-50.pkl")), pth


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dafne_torch.config import get_cfg
    from dafne_torch.data import get_dataset, register_all_datasets
    from dafne_torch.data import image_io as IO
    from dafne_torch.data import image_warp as IW
    from dafne_torch.data.mapper import eval_pad_hw, pad_target_hw, train_canvas_buckets
    from dafne_torch.data.transforms import build_test_augmentation
    from dafne_torch.data.registry import DatasetCatalog, MetadataCatalog
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
        resolve_train_device_aug,
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
    phase(1, "card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    sources = ("quad_nms", "assign", "deform_conv", "int8_conv", "png_unfilter", "image_warp",
               "jpeg_decode")
    with ThreadPoolExecutor(len(sources)) as pool:  # one compiler per source, all at once
        build_logs = dict(zip(sources, pool.map(kbuild.build, sources)))
    log(f"[build] nvcc sm_90a quad_nms.cu, assign.cu, deform_conv.cu, int8_conv.cu and g++ "
        f"png_unfilter.cpp (the host "
        f"unfilter of phase 15), image_warp.cpp (the host warps of phase 16) and "
        f"jpeg_decode.cpp (the host JPEG decoder of phase 19) in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
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
    phase(2, "suppression kernel vs plain")
    s_by_mix = {}
    for mix, n_valid in (("dense-15cls", n), ("25pct-valid", n // 4)):
        corners, classes = class_major_mix(rng, b, n, n_valid)
        bits, s_plain = check_k1(corners, classes, 0.1, mix)
        ms = cuda_ms(lambda: K.suppression_bits_cuda(corners, classes, 0.1))
        dev = device_ms(lambda: K.suppression_bits_cuda(corners, classes, 0.1), K1_KERNEL)
        plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(corners, classes, 0.1),
                           reps=PLAIN_REPS, warmup=0)
        (bound, by), pairs, no_fma, layouts = K.suppression_bound(classes, n)
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
    phase(3, "greedy kernel vs plain walk")
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
        plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s, keep_init), reps=PLAIN_REPS, warmup=0)
        (bound, by), int8_bound, floor = K.greedy_bound(k_kernel, n)
        log(f"[greedy {mix}] B={s.shape[0]} N={n} kept={int(k_kernel.sum())} differing=0 "
            f"kernel_ms={ms:.4f} device_ms={fmt_ms(dev)} plain_ms={plain_ms:.2f} bound_ms={bound:.5f} "
            f"({by}, bit-row words; over int8 S {int8_bound:.5f}) serial_floor_ms={floor:.5f} "
            f"[{card}]")
    del s_by_mix, chain, bits

    # ---- 4. main path ------------------------------------------------------
    phase(4, "main path")
    torch.backends.cudnn.benchmark = True
    cfg = get_cfg()
    cfg.INPUT.MIN_SIZE_TEST = cfg.INPUT.MAX_SIZE_TEST = CANVAS  # requests at unit scale
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
    images, scale = predictor.canvas(requests[:b])
    pinned = images.cpu().pin_memory()
    host = {
        "detect_ms": host_ms(lambda: predictor.detect(requests[:b])),
        "canvas_ms": host_ms(lambda: predictor.canvas(requests[:b])),
        "h2d_ms": host_ms(lambda: pinned.to("cuda", non_blocking=True)),
        "eval_step_ms": host_ms(lambda: predictor.step(images, scale)),
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
        decode_busy = device_ms(lambda: decode_detections(head, spec), "", reps=10,
                                launches=None)
        thr = spec.nms_threshold
        bits_main, s_plain = check_k1(pc, pk, thr, "the main path's inputs")
        keep_main = check_greedy(bits_main, s_plain, pv, "the main path's inputs")
        k1_ms = cuda_ms(lambda: K.suppression_bits_cuda(pc, pk, thr))
        k1_plain_ms = cuda_ms(lambda: K.suppression_matrix_plain(pc, pk, thr), reps=3, warmup=1)
        g_ms = cuda_ms(lambda: K.greedy_keep_bits_cuda(bits_main, pv))
        # the same through the torch.ops.dafne ops the eval step calls (the
        # dispatcher's host time in them)
        k1_op_ms = cuda_ms(lambda: torch.ops.dafne.suppression_bits(pc, pk, thr, 1e-6))
        g_op_ms = cuda_ms(lambda: torch.ops.dafne.greedy_keep_bits(bits_main, pv))
        k1_dev = device_ms(lambda: K.suppression_bits_cuda(pc, pk, thr), K1_KERNEL)
        g_dev = device_ms(lambda: K.greedy_keep_bits_cuda(bits_main, pv), GREEDY_KERNEL)
        g_plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s_plain, pv), reps=3, warmup=1)
    (k1_bound, k1_by), pairs, k1_no_fma, k1_layouts = K.suppression_bound(pk, pk.shape[1])
    (g_bound, g_by), g_int8_bound, g_floor = K.greedy_bound(keep_main, pk.shape[1])
    k1_live = int(K.live_blocks(pk).sum())
    n_img = WINDOWS * len(requests)
    log(f"[main] R-50 DOTA {CANVAS}x{CANVAS} bf16 batch {b}: {n_img / sum(windows_s):.2f} img/s "
        f"({n_img} requests in {WINDOWS} windows of {WINDOW_BATCHES} batches, "
        f"{sum(windows_s) * 1e3:.1f} ms wall, host included; window seconds "
        f"{windows_s}) [{card}]")
    log(f"[main] per batch of {b}: model_ms={model_ms:.3f} decode_ms={decode_ms:.3f} "
        f"(device busy {fmt_ms(decode_busy, 3)}: the sum of its kernels' device time) "
        f"(of which K1_ms={k1_ms:.4f} greedy_ms={g_ms:.4f}, through torch.ops.dafne K1 "
        f"{k1_op_ms:.4f} greedy {g_op_ms:.4f}; device alone K1 {fmt_ms(k1_dev)}, "
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
    (ng_bound, _), ng_int8_bound, ng_floor = K.greedy_bound(nkeep, npk.shape[1])
    log(f"[main no-cap] the same batch with TPU.NMS_MAX_CANDIDATES 0: NMS N={npk.shape[1]} "
        f"(valid {int(npv.sum())}), K1 bits equal to the packed plain S, greedy equal to the "
        f"plain walk (kept {int(nkeep.sum())}); decode_ms={ndecode_ms:.3f} greedy_ms={ng_ms:.4f} "
        f"device alone greedy {fmt_ms(ng_dev)} K1 {fmt_ms(nk1_dev)}; greedy bound_ms="
        f"{ng_bound:.5f} (bit-row words; over int8 S {ng_int8_bound:.5f}) "
        f"serial_floor_ms={ng_floor:.5f} [{card}]")
    del ncand, nbits, ns_plain, nout

    # ---- 5. small float32 reference: card (kernels) vs CPU (plain) ---------
    phase(5, "small float32 reference: card (kernels) vs CPU (plain)")
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
    phase(6, "assignment kernel (K3) vs plain")
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
    phase(7, "training path at full width")
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
    phase(8, "overfit one fixed batch")
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
    phase(9, "one narrow float32 train step: card (kernel) vs CPU (plain)")
    ncfg = get_cfg()
    ncfg.merge_from_list(DOTA_1024 + NARROW + [
        "SOLVER.WARMUP_ITERS", "0", "INPUT.MIN_SIZE_TRAIN", "(256,)",
        "INPUT.MAX_SIZE_TRAIN", "256", "SOLVER.IMS_PER_BATCH", "2"])
    nmap = DatasetMapper(ncfg, (256, 256))
    recs = load_synthetic_gen("train", 2, hw=256, max_boxes=24)
    examples = [nmap(r, np.random.RandomState(10 + i)) for i, r in enumerate(recs)]
    same_labels, n_locs, rel, p_err, _, m_cpu = narrow_step_card_vs_cpu(ncfg, examples, 4)
    log(f"[train reference] narrow R-50 f32 batch 2 at 256x256, one step: labels equal on "
        f"{same_labels:.6f} of {n_locs} locations; loss relative differences "
        f"{json.dumps(rel)}; max |param diff| after the step {p_err:.3g}; losses (CPU) "
        f"{json.dumps({k: m_cpu[k] for k in rel})}")
    if same_labels < 0.999 or max(rel.values()) > 1e-4 or p_err > 1e-5:
        raise SystemExit("the card's train step disagrees with the CPU reference")
    torch.cuda.empty_cache()

    # ---- 10. 2-D tiled suppression kernel (K2) vs plain ---------------------
    phase(10, "2-D tiled suppression kernel (K2) vs plain")
    score_order = class_major_mix(rng, b, n, n, class_major=False)
    for mix, (corners, classes) in (("dense-15cls-score-order", score_order),
                                    ("25pct-valid-class-major", quarter_mix)):
        check_k2(corners, classes, mix, card)
    del score_order, quarter_mix

    # ---- 11. the eval path at full width -----------------------------------
    phase(11, "the eval path at full width")
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
                                                   reps=10, launches=None),
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
        (gk1_bound, gk1_by), gpairs, gk1_no_fma, _ = K.suppression_bound(pk, pk.shape[1])
        gg_ms = cuda_ms(lambda: K.greedy_keep_bits_cuda(bits_, pv))
        gg_plain_ms = cuda_ms(lambda: K.greedy_keep_plain(s_, pv), reps=3, warmup=1)
        (gg_bound, gg_by), gg_int8_bound, gg_floor = K.greedy_bound(k_kernel, pv.shape[1])
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
    # traced in the order pallas, pallas-2d, pallas: a run of traces can miss
    # the same few events in each of its traces, so each name keeps its most
    per_impl = {"pallas": Counter(), "pallas-2d": Counter()}
    totals = []
    for _ in range(KERNEL_COUNT_ROUNDS):
        for impl in ("pallas", "pallas-2d", "pallas"):
            counts = device_kernels(lambda: rotated_nms_grouped_batched(
                c0["corners"], c0["scores"], c0["classes"], c0["valid"], thr, gspec.class_merge,
                gspec.num_classes, GROUP_K, min_total, impl=impl), traces=KERNEL_COUNT_TRACES)
            per_impl[impl] |= counts
        totals.append([sum(per_impl[i].values()) for i in ("pallas", "pallas-2d")])
        extra = {k: n - per_impl["pallas"][k] for k, n in per_impl["pallas-2d"].items()
                 if K2_KERNEL not in k and n > per_impl["pallas"][k]}
        if not extra:
            break
    log(f"[eval] replay of the grouped NMS of {len(cands)} batches with impl=pallas-2d: K2 launches "
        f"{k2_launches}; keep-sets differing from impl=pallas: {differ} of "
        f"{sum(int(k.sum()) for k in keeps)} kept; kernels per grouped NMS call (profiler, most "
        f"over {len(totals)} round(s) of traces; [pallas, pallas-2d] after each round {totals}): "
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
    phase(12, "narrow float32 do_test: card (kernels) vs CPU (plain)")
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
    phase(13, "TTA at full width: the DOTA-1.0 1024 recipe's ladder")
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
    phase(14, "train-time augmentation rendered on the card")
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
    phase(15, "datasets on disk: the DOTA-1.0 1024 recipe through the CLI")
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

    # ---- 16. the HRSC2016 multi-scale recipe: train, evaluate, serve, TTA ----
    phase(16, "the HRSC2016 multi-scale recipe: train, evaluate, serve, TTA")
    # phases 16 and 17 run under the CLI's own cuDNN setting (benchmark off,
    # as phases 19b and 20): under phase 4's benchmark the searches for their
    # new canvases took 57 s of HRSC's first steps and 35 s of R-101's on an
    # H100 80GB HBM3 at 700 W
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    hrsc_dir = os.path.join(ROOT, "output", "chip_smoke_hrsc")
    shutil.rmtree(hrsc_dir, ignore_errors=True)
    os.environ["DAFNE_DATA_DIR"] = os.path.join(hrsc_dir, "data")
    t0 = time.perf_counter()
    htree = write_hrsc_tree(os.path.join(hrsc_dir, "data", "hrsc"),
                            {"trainval": N_HRSC_TRAIN, "test": N_HRSC_TEST},
                            np.random.RandomState(16))
    for path, want in htree["expected"].items():
        if not np.array_equal(IO.read_image(path), want):
            raise SystemExit(f"{path} did not decode to the array written")
    log(f"[hrsc] HRSC2016 tree: {N_HRSC_TRAIN} trainval and {N_HRSC_TEST} test 24-bit BMPs of "
        f"(w, h) {sorted({(a.shape[1], a.shape[0]) for a in htree['expected'].values()})}, ships "
        f"drawn as filled rotated rectangles, {len(htree['planted'])} images with a planted point "
        f"and axis-aligned segment; written and each decoded back to the array written in "
        f"{time.perf_counter() - t0:.1f} s (host set-up)")
    recipe = os.path.join(ROOT, HRSC_RECIPE)
    # the recipe's global batch of 8 on the one card; the CLI reads the YAML
    hrsc_args = ["--config-file", recipe, "SOLVER.REFERENCE_WORLD_SIZE", "0",
                 "SOLVER.IMS_PER_BATCH", str(b), "TPU.EVAL_BATCH", str(b), "SEED", str(HRSC_SEED),
                 "MODEL.WEIGHTS", pkl]
    hcfg = get_cfg()
    hcfg.merge_from_file(recipe)
    hcfg.merge_from_list(hrsc_args[2:])
    register_all_datasets(hcfg)
    ladder = train_canvas_buckets(hcfg, get_dataset("hrsc_trainval", hcfg))
    draw_rng = np.random.RandomState(HRSC_SEED * 7919 + 13)  # the loader's per-batch stream
    drawn = [ladder.draw(draw_rng) for _ in range(HRSC_STEPS)]
    log(f"[hrsc] bucket ladder (h, w) {ladder.canvases} for the recipe's scales {ladder.sizes} "
        f"(MAX_SIZE_TRAIN {hcfg.INPUT.MAX_SIZE_TRAIN}, TRAIN_MAX_BUCKETS "
        f"{hcfg.TPU.TRAIN_MAX_BUCKETS}); SEED {HRSC_SEED} draws scales {[d[0] for d in drawn]}: "
        f"canvases {[d[1] for d in drawn]}")

    # train through the CLI: the 30-degree angles keep the augmentation on the host
    htrain_dir = os.path.join(hrsc_dir, "train")
    IW.reset_launch_counts()
    A.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    htrain = {}
    t0 = time.perf_counter()
    with WarpRecorder(IW) as rec:
        cli_main(hrsc_args + ["SOLVER.MAX_ITER", str(HRSC_STEPS), "DATASETS.TEST", "()",
                              "OUTPUT_DIR", htrain_dir], train_stats=htrain)
    torch.cuda.synchronize()
    hcli_s = time.perf_counter() - t0
    hrsc_k3 = A.assign_argmin_cuda.launches
    hpeak_gib = torch.cuda.max_memory_allocated() / 2**30
    hsteps = htrain["steps"]
    want_hits = {c: sum(d[1] == c for d in drawn) for c in {d[1] for d in drawn}}
    if hrsc_k3 != HRSC_STEPS or {c: len(v["ms"]) for c, v in hsteps.items()} != want_hits:
        raise SystemExit(f"hrsc train: K3 {hrsc_k3} for {HRSC_STEPS} steps; steps per canvas "
                         f"{ {c: len(v['ms']) for c, v in hsteps.items()} }, drawn {want_hits}")
    if len(hsteps) < 2 or any(v["builds"] != 1 for v in hsteps.values()):
        raise SystemExit(f"hrsc train: canvases {list(hsteps)}, builds "
                         f"{ {c: v['builds'] for c, v in hsteps.items()} }")
    hlosses = [x for v in hsteps.values() for x in v["loss"]]
    if not all(np.isfinite(hlosses)):
        raise SystemExit(f"hrsc train: non-finite losses {hlosses}")
    resize_ms, warp_ms = rec.ms("resize"), rec.ms("warp")
    launched = (IW.resize_linear.launches, IW.warp_affine_linear.launches)
    warp_counts, warp_check_s = rec.check("hrsc train")
    step_split = {f"{h}x{w}": {"steps": len(v["ms"]), "first_ms": round(v["ms"][0], 2),
                               "later_median_ms": (round(statistics.median(v["ms"][1:]), 2)
                                                   if len(v["ms"]) > 1 else None)}
                  for (h, w), v in sorted(hsteps.items())}
    log(f"[hrsc] CLI --config-file {HRSC_RECIPE}, R-50 full width, 1 class, batch {b}, "
        f"{HRSC_STEPS} steps from the R-50.pkl in {hcli_s:.2f} s wall (model build, loader, "
        f"steps, checkpoint); K3 {hrsc_k3} launches (once per step); each canvas's step built "
        f"once; step ms per canvas on CUDA events (the first apart: the step's build; cuDNN's "
        f"heuristics) {json.dumps(step_split)}; total loss per step in canvas order "
        f"{[round(x, 4) for x in hlosses]}; peak memory {hpeak_gib:.2f} GiB "
        f"(max_memory_allocated) [{card}]")
    log(f"[hrsc] host warps on the loader's threads (host clock per image, median and range): "
        f"resize_linear {statistics.median(resize_ms):.2f} ms ({min(resize_ms):.2f}-"
        f"{max(resize_ms):.2f}, {len(resize_ms)} images: angle 0 or 90), warp_affine_linear "
        f"{statistics.median(warp_ms):.2f} ms ({min(warp_ms):.2f}-{max(warp_ms):.2f}, "
        f"{len(warp_ms)} images: 30, 60, 120 or 150 degrees); library calls {launched} "
        f"(prefetched batches included); every output equal to the plain NumPy version "
        f"{warp_counts} (checked in {warp_check_s:.1f} s on 8 threads) [{card}]")
    map_loader = DataLoader(hcfg, get_dataset("hrsc_trainval", hcfg), b, seed=1, pin_memory=True,
                            buckets=ladder)
    hmap_ms = {}
    with ThreadPoolExecutor(hcfg.DATALOADER.NUM_WORKERS) as pool:
        for scale in (min(ladder.sizes), max(ladder.sizes)):
            canvas = ladder.canvas_for(scale)
            hmap_ms[f"scale {scale} on {canvas[0]}x{canvas[1]}"] = round(host_ms(
                lambda: map_loader.make_batch(list(range(b)), list(range(b)), pool, scale,
                                              canvas)), 2)
    log(f"[hrsc] one batch's mapping, map_ms ({b} BMP records read, augmented and placed on "
        f"{hcfg.DATALOADER.NUM_WORKERS} threads, host clock, median of 3): {json.dumps(hmap_ms)} "
        f"[{card}]")

    # K3 against its plain version on each canvas's location table, on a batch
    # mapped at the largest scale drawn for that canvas
    hspec = AssignmentSpec.from_config(hcfg)
    for canvas in sorted(want_hits):
        scale = max(d[0] for d in drawn if d[1] == canvas)
        hb_ = to_device(map_loader.make_batch(list(range(b)), list(range(b)), None, scale,
                                              canvas), "cuda")
        err = check_assign(hspec, make_location_tables(canvas, hspec, device="cuda"), hb_,
                           f"hrsc canvas {canvas[0]}x{canvas[1]} scale {scale}", card)[5]
        max_err["assign_argmin"] = max(max_err["assign_argmin"], err)

    # evaluate: --eval-only on hrsc_test at 800/1333 from the checkpoint
    K.reset_launch_counts()
    IW.reset_launch_counts()
    hstats = {}
    t0 = time.perf_counter()
    with WarpRecorder(IW) as rec:
        results = cli_main(["--eval-only"] + hrsc_args + [
            "DATASETS.TEST", "('hrsc_test',)", "TEST.AUG.ENABLED", "False",
            "OUTPUT_DIR", htrain_dir], stats=hstats)
    hcli_s = time.perf_counter() - t0
    heval_launches = {"suppression_matrix": K.suppression_bits_cuda.launches,
                      "greedy_keep": K.greedy_keep_bits_cuda.launches}
    n_hbatches = -(-N_HRSC_TEST // b)
    eval_counts, eval_check_s = rec.check("hrsc eval")
    hst = hstats["hrsc_test"]
    hmap = results["hrsc_test"].get("mAP")
    test_records = get_dataset("hrsc_test", hcfg)
    resized = sum((a.out_w, a.out_h) != (r["width"], r["height"]) for r in test_records
                  for a in [build_test_augmentation(hcfg, r["width"], r["height"])])
    if set(heval_launches.values()) != {n_hbatches} or eval_counts["resize"] != resized:
        raise SystemExit(f"hrsc eval: launches {heval_launches} for {n_hbatches} batches, "
                         f"library calls {eval_counts} for {resized} images that resize")
    if hst["images"] != N_HRSC_TEST or not isinstance(hmap, float) or not np.isfinite(hmap):
        raise SystemExit(f"hrsc eval: {hst['images']} images, mAP {hmap}")
    hpad = eval_pad_hw(hcfg, test_records)
    emapper = DatasetMapper(hcfg, hpad, train=False)
    kept = [int(emapper(r)["gt_valid"].sum()) for r in test_records]
    want_kept = [len(r["annotations"]) - htree["planted"].get(r["image_id"], 0)
                 for r in test_records]
    if kept != want_kept:
        raise SystemExit(f"hrsc eval mapper kept {kept} objects, expected {want_kept}")
    log(f"[hrsc] CLI --eval-only on hrsc_test ({N_HRSC_TEST} BMPs, MIN_SIZE_TEST "
        f"{hcfg.INPUT.MIN_SIZE_TEST}, MAX_SIZE_TEST {hcfg.INPUT.MAX_SIZE_TEST}, eval canvas "
        f"{hpad[0]}x{hpad[1]}, batch {b}) in {hcli_s:.2f} s wall; launches {heval_launches} "
        f"(once per batch); every eval image's resize equal to the plain version {eval_counts} "
        f"({N_HRSC_TEST - resized} images of 1280x800 at unit scale) "
        f"(checked in {eval_check_s:.1f} s); the planted objects dropped by the eval mapper; "
        f"eval loop {hst['images']} images {hst['loop_s']:.3f} s = "
        f"{hst['images'] / hst['loop_s']:.2f} img/s (host clock; decode from BMP, resize, "
        f"model, NMS, fetch); evaluate() {hst['evaluate_s']:.3f} s; mAP {hmap:.4f} (random "
        f"head, {HRSC_STEPS} steps) [{card}]")
    # the eval loop again in this process, after its shapes' first calls
    smodel = build_model(hcfg, device="cuda")
    Checkpointer(htrain_dir).resume_or_load(smodel, hcfg, resume=True)
    ecfg_ = copy.deepcopy(hcfg)
    ecfg_.DATASETS.TEST = ("hrsc_test",)
    K.reset_launch_counts()
    warm = {}
    train_loop.do_test(ecfg_, smodel, None, stats=warm)
    heval_warm = K.suppression_bits_cuda.launches
    wst = warm["hrsc_test"]
    log(f"[hrsc] the same eval loop again (do_test, the checkpoint's weights, its shapes' first "
        f"calls done): {wst['images']} images {wst['loop_s']:.3f} s = "
        f"{wst['images'] / wst['loop_s']:.2f} img/s (host clock); K1 {heval_warm} launches "
        f"[{card}]")
    if heval_warm != n_hbatches:
        raise SystemExit(f"hrsc eval again: K1 launched {heval_warm} times")
    # from here the class bias is -2, as in phases 4 and 11, so that the NMS
    # inputs, the requests' detections and the TTA merge are full
    with torch.no_grad():
        smodel.head.cls_logits.bias.fill_(-2.0)
    smodel.eval()
    # K1 and greedy against their plain versions on the non-square eval canvas
    hloader = DataLoader(hcfg, test_records, b, pad_hw=hpad, train=False)
    hdspec = DecodeSpec.from_config(hcfg)
    hbatches = iter(hloader)
    hbatch = next(hbatches)
    hbatches.close()
    with torch.inference_mode():
        hc = nms_candidates(smodel(hbatch["image"].cuda()), hdspec)
        _, hpc, hpk, hpv = sorted_nms_inputs(hc["corners"], hc["scores"], hc["classes"],
                                             hc["valid"], hdspec.class_merge, scores01=True)
        hbits, hs = check_k1(hpc, hpk, hdspec.nms_threshold, "the hrsc eval canvas")
        hkeep = check_greedy(hbits, hs, hpv, "the hrsc eval canvas")
    log(f"[hrsc] K1's bits equal to the packed plain S and greedy's keep-set to the plain walk "
        f"on the first eval batch's NMS input ({list(hpk.shape)} on the {hpad[0]}x{hpad[1]} "
        f"canvas; {int(hpv.sum())} valid slots, {int(hkeep.sum())} kept) [{card}]")
    del hbits, hs, hc

    # serve: three requests of different sizes through the Predictor
    req_rng = np.random.RandomState(17)
    serve_records = []
    for n, (w, h) in enumerate(((1500, 900), (900, 1500), (500, 333))):
        img, ships = draw_ships(w, h, 4, req_rng)
        serve_records.append({"image": img, "image_id": f"request{n}", "width": w, "height": h,
                              "annotations": [{"corners": ship_corners(*sh).reshape(8).tolist(),
                                               "category_id": 0} for sh in ships]})
    requests = [r["image"] for r in serve_records]
    predictor = Predictor(smodel, hcfg, batch=b)
    if eval_pad_hw(hcfg, serve_records) != predictor.canvas_hw:
        raise SystemExit(f"serve: the requests' eval canvas differs from {predictor.canvas_hw}")
    IW.reset_launch_counts()
    with WarpRecorder(IW) as rec:
        canvas, scale = predictor.canvas(requests)
    smapper = DatasetMapper(hcfg, predictor.canvas_hw, train=False)
    for i, r in enumerate(serve_records):
        want = smapper(r)
        if not (np.array_equal(canvas[i].cpu().numpy(), want["image"])
                and np.array_equal(scale[i].cpu().numpy(), want["scale_xy"])):
            raise SystemExit(f"serve: request {i}'s canvas or scale differs from the eval mapper's")
    serve_counts, _ = rec.check("hrsc serve")
    K.reset_launch_counts()
    serve_ms = []
    for _ in range(2):  # the first call pays the canvas's first cuDNN calls
        t0 = time.perf_counter()
        dets = predictor.detect(requests)
        serve_ms.append(round((time.perf_counter() - t0) * 1e3, 1))
    serve_launches = K.suppression_bits_cuda.launches
    DatasetCatalog.register("hrsc_serve", lambda: serve_records)
    MetadataCatalog["hrsc_serve"] = dict(MetadataCatalog.get("hrsc_test"), split="serve")
    scfg = copy.deepcopy(hcfg)
    scfg.DATASETS.TEST = ("hrsc_serve",)
    sstats = {}
    K.reset_launch_counts()
    train_loop.do_test(scfg, smodel, None, stats=sstats)
    serve_launches += K.suppression_bits_cuda.launches
    got = {f"request{i}": {"corners": np.asarray([d["corners"] for d in per], np.float32).reshape(-1, 8),
                           "scores": np.asarray([d["score"] for d in per], np.float32),
                           "classes": np.asarray([d["class"] for d in per])}
           for i, per in enumerate(dets)}
    want = sstats["hrsc_serve"]["preds"]
    m1, t1 = match_rate(got, want)
    m2, t2 = match_rate(want, got)
    if m1 != t1 or m2 != t2 or t1 == 0:
        raise SystemExit(f"serve: Predictor matched {m1}/{t1} of do_test's detections and "
                         f"do_test {m2}/{t2} of the Predictor's")
    log(f"[hrsc] serve: 3 requests (w, h) (1500, 900), (900, 1500), (500, 333) through "
        f"Predictor.detect at batch {b}: {serve_ms} ms wall (first and second call); canvases and "
        f"scale_xy equal to the eval mapper's on the {predictor.canvas_hw[0]}x"
        f"{predictor.canvas_hw[1]} canvas, resizes equal to the plain version {serve_counts}; "
        f"detections equal to do_test's on the same images ({t1} detections, score within 1e-4, "
        f"corners within 1e-2, both ways); K1 and greedy {serve_launches} launches each "
        f"(two detect calls and do_test, one batch each) [{card}]")
    if serve_launches != 3:
        raise SystemExit(f"serve: K1 launched {serve_launches} times for 3 batches")

    # TTA: 30-degree copies through the host warp, then every copy on the host
    DatasetCatalog.register("hrsc_tta", lambda: test_records[:N_HRSC_TTA])
    MetadataCatalog["hrsc_tta"] = dict(MetadataCatalog.get("hrsc_test"), split="tta")
    hrsc_tta_launches = 0
    tta_split = {}
    for device_aug in (True, False):
        tcfg_ = copy.deepcopy(hcfg)
        tcfg_.merge_from_list(["DATASETS.TEST", "('hrsc_tta',)", "TEST.AUG.MIN_SIZES",
                               HRSC_TTA_SIZES, "TEST.AUG.ROTATION_ANGLES", "(30.0,)",
                               "TPU.TTA_DEVICE_AUG", str(device_aug)])
        K.reset_launch_counts()
        IW.reset_launch_counts()
        tstats = {}
        with WarpRecorder(IW) as rec:
            TTA.do_test_with_tta(tcfg_, smodel, None, stats=tstats)
        launched = {"suppression_matrix": K.suppression_bits_cuda.launches,
                    "greedy_keep": K.greedy_keep_bits_cuda.launches}
        tcounts, tcheck_s = rec.check(f"hrsc TTA (device aug {device_aug})")
        ts = tstats["hrsc_tta"]
        per = ts["per_image"]
        n_steps = sum(sum(p["steps"].values()) for p in per)
        want_host = 6 if device_aug else 9
        if set(launched.values()) != {n_steps} or any(
                p["copies"] != 9 or p["host_copies"] != want_host for p in per):
            raise SystemExit(f"hrsc TTA (device aug {device_aug}): launches {launched} for "
                             f"{n_steps} eval steps; copies {[(p['copies'], p['host_copies']) for p in per]}")
        hrsc_tta_launches += n_steps
        tta_split[device_aug] = {
            "s_per_image": round(ts["loop_s"] / ts["images"], 3),
            "wall_ms": [round(p["wall_ms"], 1) for p in per],
            "host_warp_ms": [round(p["host_warp_ms"], 1) for p in per],
            "device_warp_ms": [round(p["warp_ms"], 2) for p in per],
            "merge_ms": [round(p["merge_ms"], 1) for p in per],
            "eval_steps": per[0]["steps"], "boxes_in": [p["boxes_in"] for p in per],
            "boxes_out": [p["boxes_out"] for p in per], "library_calls": tcounts}
        log(f"[hrsc] TTA on {ts['images']} test images, MIN_SIZES {HRSC_TTA_SIZES} (the recipe's "
            f"16-scale ladder cut for time), ROTATION_ANGLES (30,), HFLIP: 9 copies each, "
            f"TPU.TTA_DEVICE_AUG {device_aug} ({want_host} copies rendered on the host): "
            f"{json.dumps(tta_split[device_aug])} (host clock but device_warp_ms and the eval "
            f"steps, on CUDA events); K1 and greedy {n_steps} launches each, once per eval step; "
            f"every host copy equal to the plain version (checked in {tcheck_s:.1f} s) [{card}]")
    hrsc_nms_launches = 2 * n_hbatches + serve_launches + hrsc_tta_launches
    del smodel, predictor
    torch.cuda.empty_cache()

    # ---- 17. the model's options: the ablation recipe, each option, R-101 ----
    phase(17, "the model's options: the ablation recipe, each option, R-101")
    t17 = time.perf_counter()
    opt_dir = os.path.join(ROOT, "output", "chip_smoke_options")
    shutil.rmtree(opt_dir, ignore_errors=True)
    os.environ["DAFNE_DATA_DIR"] = data_dir  # phase 15's DOTA tree
    opt_launches = {"suppression_matrix": 0, "greedy_keep": 0, "assign_argmin": 0}
    r101_launches = dict(opt_launches)

    def hold_k3_on_loader(cfg_, records_, steps, what):
        """K3 against its plain version on the first `steps` batches of the
        train loader a CLI run of `cfg_` over `records_` draws (its seed,
        its batch, its bucket ladder), each on its canvas's location
        tables."""
        ladder_ = train_canvas_buckets(cfg_, records_)
        loader_ = DataLoader(cfg_, records_, cfg_.SOLVER.IMS_PER_BATCH, seed=max(cfg_.SEED, 0),
                             pad_hw=pad_target_hw(cfg_, train=True),
                             device_aug=resolve_train_device_aug(cfg_), buckets=ladder_)
        spec_ = AssignmentSpec.from_config(cfg_)
        tables_, err, canvases = {}, 0.0, []
        batches_ = iter(loader_)
        for i in range(steps):
            hb = next(batches_)
            hw = train_loop.batch_canvas_hw(hb)
            if hw not in tables_:
                tables_[hw] = make_location_tables(hw, spec_, device="cuda")
            err = max(err, assign_equal(spec_, tables_[hw], to_device(hb, "cuda"),
                                        f"{what} step {i} canvas {hw}")[0])
            canvases.append(hw)
        batches_.close()
        return err, canvases

    def bias_minus_2_checkpoint(cfg_, out_dir):
        """A checkpoint after the newest in `out_dir` with the class bias
        -2 (as phases 4, 11 and 16), so that the NMS inputs are full."""
        m = build_model(cfg_, device="cuda")
        ck = Checkpointer(out_dir)
        at = ck.resume_or_load(m, cfg_, resume=True)
        with torch.no_grad():
            m.head.cls_logits.bias.fill_(-2.0)
        ck.save(at + 1, m)
        return m

    # (a) the paper's ablation recipe through the CLI: train, then --eval-only
    abl_dir = os.path.join(opt_dir, "ablation")
    abl_recipe = os.path.join(ROOT, ABLATION_RECIPE)
    abl_args = ["--config-file", abl_recipe, "SOLVER.REFERENCE_WORLD_SIZE", "0",
                "SOLVER.IMS_PER_BATCH", str(b), "TPU.EVAL_BATCH", str(b), "MODEL.WEIGHTS", pkl,
                "DATASETS.TRAIN", "('dota_1_train_1024',)", "DATASETS.TEST",
                "('dota_1_val_1024',)", "OUTPUT_DIR", abl_dir]
    acfg = get_cfg()
    acfg.merge_from_file(abl_recipe)
    acfg.merge_from_list(abl_args[2:])
    register_all_datasets(acfg)
    A.reset_launch_counts()
    atrain = {}
    # the train loop's run-time services on this run (no table quotes its
    # step times): a profiler window over steps 1-2, the run report piped
    # to DAFNE_NOTIFY_CMD, asynchronous saves every SERVICES_CKPT_PERIOD
    hook_path = os.path.join(abl_dir, "notify_stdin.json")
    os.environ["DAFNE_NOTIFY_CMD"] = f"cat > '{hook_path}'"
    t0 = time.perf_counter()
    try:
        cli_main(abl_args + ["SOLVER.MAX_ITER", str(ABL_STEPS), "DATASETS.TEST", "()",
                             "DEBUG.PROFILE_ITERS", str(list(SERVICES_WINDOW)),
                             "SOLVER.CHECKPOINT_PERIOD", str(SERVICES_CKPT_PERIOD)],
                 train_stats=atrain)
    finally:
        del os.environ["DAFNE_NOTIFY_CMD"]
    torch.cuda.synchronize()
    abl_train_s = time.perf_counter() - t0
    check_services(acfg, abl_dir, hook_path, atrain["checkpoints"], card)
    abl_k3 = A.assign_argmin_cuda.launches
    alosses = [x for v in atrain["steps"].values() for x in v["loss"]]
    ams = [x for v in atrain["steps"].values() for x in v["ms"]]
    if abl_k3 != ABL_STEPS or len(alosses) != ABL_STEPS or not all(np.isfinite(alosses)):
        raise SystemExit(f"ablation train: K3 {abl_k3} for {ABL_STEPS} steps, losses {alosses}")
    err, _ = hold_k3_on_loader(acfg, get_dataset("dota_1_train_1024", acfg), ABL_STEPS,
                               "ablation train")
    max_err["assign_argmin"] = max(max_err["assign_argmin"], err)
    amodel = bias_minus_2_checkpoint(acfg, abl_dir)
    if hasattr(amodel.head, "ctrness") or hasattr(amodel.head, "center_pred"):
        raise SystemExit("the ablation head has a centerness or a center branch")
    K.reset_launch_counts()
    astats = {}
    t0 = time.perf_counter()
    ares = cli_main(["--eval-only"] + abl_args, stats=astats)
    abl_eval_s = time.perf_counter() - t0
    abl_nms = {"suppression_matrix": K.suppression_bits_cuda.launches,
               "greedy_keep": K.greedy_keep_bits_cuda.launches}
    aval = get_dataset("dota_1_val_1024", acfg)
    n_abatches = -(-len(aval) // b)
    amap = ares["dota_1_val_1024"].get("mAP")
    if set(abl_nms.values()) != {n_abatches} or not np.isfinite(amap):
        raise SystemExit(f"ablation eval: launches {abl_nms} for {n_abatches} batches, mAP {amap}")
    aspec = DecodeSpec.from_config(acfg)
    held = []
    with torch.inference_mode():
        for i, batch in enumerate(DataLoader(acfg, aval, b, pad_hw=eval_pad_hw(acfg, aval),
                                             train=False)):
            held.append(hold_nms(amodel(batch["image"].cuda()), aspec, f"ablation eval batch {i}"))
    ast = astats["dota_1_val_1024"]
    log(f"[options] ablation recipe {ABLATION_RECIPE} (R-50, CORNER_PREDICTION direct, "
        f"CENTERNESS none) through the CLI: {ABL_STEPS} train steps from the R-50.pkl on "
        f"dota_1_train_1024 in {abl_train_s:.2f} s wall, step ms (CUDA events) "
        f"{[round(x, 2) for x in ams]}, total loss {[round(x, 4) for x in alosses]}; K3 "
        f"{abl_k3} launches, equal to its plain version on each step's batch; --eval-only on "
        f"{ast['images']} val tiles (class bias -2) in {abl_eval_s:.2f} s wall, eval loop "
        f"{ast['images'] / ast['loop_s']:.2f} img/s, mAP {amap:.4f}; K1 and greedy {abl_nms} "
        f"launches, equal to their plain versions on every eval batch's NMS input (rows, "
        f"valid, kept) {held} [{card}]")
    for k in ("suppression_matrix", "greedy_keep"):
        opt_launches[k] += abl_nms[k]
    opt_launches["assign_argmin"] += abl_k3
    del amodel
    torch.cuda.empty_cache()

    # (b) each other option alone on the DOTA-1.0 1024 recipe's model
    omapper = DatasetMapper(train_cfg, (CANVAS, CANVAS))
    obatches = []
    for i in range(OPT_STEPS):
        ex = [omapper(r, np.random.RandomState(170 + 8 * i + j))
              for j, r in enumerate(train_records[(i % 2) * b:(i % 2 + 1) * b])]
        ob = gt_tensors(ex, "cuda")
        ob["image"] = torch.from_numpy(np.stack([e["image"] for e in ex])).cuda()
        obatches.append(ob)
    oimages = torch.from_numpy(np.stack([r["image"] for r in val_scenes[:b]])).cuda()
    option_rows = {}
    for name, extra in OPTION_CASES:
        ocfg = copy.deepcopy(train_cfg)
        ocfg.merge_from_list(extra)
        t0 = time.perf_counter()
        omodel = build_model(ocfg, device="cuda", generator=torch.Generator().manual_seed(17))
        optimizer, scheduler = build_optimizer(ocfg, omodel)
        ostep = make_train_step(omodel, ocfg, (CANVAS, CANVAS), optimizer, scheduler)
        ospec = AssignmentSpec.from_config(ocfg)
        otables = make_location_tables((CANVAS, CANVAS), ospec, device="cuda")
        bn = ocfg.MODEL.DAFNE.NORM in ("BN", "SyncBN")
        running = lambda: {k: v.clone() for k, v in omodel.state_dict().items()
                           if k.startswith("head.") and ".running_" in k}
        A.reset_launch_counts()
        losses, stats_moved = [], []
        for ob in obatches:
            before = running()
            metrics = ostep(ob)
            after = running()
            stats_moved.append(bool(after) and all(not torch.equal(after[k], before[k])
                                                   for k in after))
            losses.append({k: round(float(v), 4) for k, v in metrics.items()
                           if k.startswith("loss/")})
        k3 = A.assign_argmin_cuda.launches
        for i, ob in enumerate(obatches):
            err = assign_equal(ospec, otables, ob, f"option {name} step {i}")[0]
            max_err["assign_argmin"] = max(max_err["assign_argmin"], err)
        if k3 != OPT_STEPS or not all(np.isfinite(v) for l in losses for v in l.values()):
            raise SystemExit(f"option {name}: K3 {k3} for {OPT_STEPS} steps, losses {losses}")
        if bn != bool(running()) or (bn and not all(stats_moved)):
            raise SystemExit(f"option {name}: running statistics {len(running())}, moved "
                             f"after each step {stats_moved}")
        with torch.no_grad():
            omodel.head.cls_logits.bias.fill_(-2.0)
        stats_before = running()
        estep = make_eval_step(omodel, ocfg, (CANVAS, CANVAS))
        K.reset_launch_counts()
        det = estep(oimages)
        torch.cuda.synchronize()
        nms_launched = (K.suppression_bits_cuda.launches, K.greedy_keep_bits_cuda.launches)
        if nms_launched != (1, 1) or not torch.isfinite(det["corners"]).all():
            raise SystemExit(f"option {name}: eval batch launches {nms_launched}")
        with torch.inference_mode():
            head = omodel(oimages)
            rows = hold_nms(head, DecodeSpec.from_config(ocfg), f"option {name} eval batch")
        extra_check = ""
        if bn:
            # the eval batch normalizes with the running statistics and leaves them
            if not all(torch.equal(v, stats_before[k]) for k, v in running().items()):
                raise SystemExit(f"option {name}: the eval batch moved the running statistics")
            with torch.no_grad():
                for k, v in stats_before.items():
                    if k.endswith("running_mean"):
                        omodel.state_dict()[k].add_(0.5)
                moved = estep(oimages)
                omodel.load_state_dict(stats_before, strict=False)
            if torch.equal(moved["scores"], det["scores"]):
                raise SystemExit(f"option {name}: the eval batch ignores the running statistics")
            extra_check = "; running statistics moved by each step, used and kept by the eval"
        if ocfg.MODEL.TOP_MODULE.NAME:
            dim = ocfg.MODEL.TOP_MODULE.DIM
            if [tuple(t.shape) for t in head["top_feats"]] != [(b, h, w, dim) for h, w in head["hw"]]:
                raise SystemExit(f"option {name}: top_feats {[t.shape for t in head['top_feats']]}")
            extra_check = f"; top_feats {dim} channels on every level"
        if (head["center"][0] is None) != (ocfg.MODEL.DAFNE.CORNER_PREDICTION != "center-to-corner"):
            raise SystemExit(f"option {name}: center output {head['center'][0] is None}")
        option_rows[name] = {"s": round(time.perf_counter() - t0, 2), "losses": losses,
                             "nms": rows}
        log(f"[options] {name} ({' '.join(extra)}): {OPT_STEPS} train steps, losses {losses}; K3 "
            f"{k3} launches, equal to its plain version on each step's batch; one eval batch of "
            f"{b} (class bias -2): K1 and greedy once each, equal to their plain versions on its "
            f"NMS input (rows, valid, kept) {rows}{extra_check}; "
            f"{option_rows[name]['s']:.2f} s wall with the build [{card}]")
        opt_launches["assign_argmin"] += k3
        opt_launches["suppression_matrix"] += nms_launched[0]
        opt_launches["greedy_keep"] += nms_launched[1]
        del omodel, optimizer, scheduler, ostep, estep, head, det
    del obatches, oimages
    torch.cuda.empty_cache()

    # (c) a narrow float32 BN-tower train step: card (kernels) against CPU (plain)
    bcfg = get_cfg()
    bcfg.merge_from_list(DOTA_1024 + NARROW + [
        "MODEL.DAFNE.NORM", "BN", "SOLVER.WARMUP_ITERS", "0", "INPUT.MIN_SIZE_TRAIN", "(256,)",
        "INPUT.MAX_SIZE_TRAIN", "256", "SOLVER.IMS_PER_BATCH", "2"])
    bmap = DatasetMapper(bcfg, (256, 256))
    bexamples = [bmap(r, np.random.RandomState(171 + i))
                 for i, r in enumerate(load_synthetic_gen("train", 2, hw=256, max_boxes=24))]
    same_labels, n_locs, rel, p_err, stat_err, m_cpu = narrow_step_card_vs_cpu(bcfg, bexamples, 18)
    log(f"[options] narrow R-50 f32 with BN towers, batch 2 at 256x256, one step: labels equal "
        f"on {same_labels:.6f} of {n_locs} locations; loss relative differences "
        f"{json.dumps(rel)}; max |param diff| after the step {p_err:.3g}; running statistics "
        f"after the step within {stat_err:.3g} of the largest; losses (CPU) "
        f"{json.dumps({k: m_cpu[k] for k in rel})}")
    if same_labels < 0.999 or max(rel.values()) > 1e-4 or p_err > 1e-5 or stat_err > 1e-4:
        raise SystemExit("the card's BN-tower train step disagrees with the CPU reference")

    # (d) the released R-101 recipe: bucketed training, then --eval-only with TTA
    r101_dir = os.path.join(opt_dir, "r101")
    r101_recipe = os.path.join(ROOT, R101_RECIPE)
    rcfg = get_cfg()
    rcfg.merge_from_file(r101_recipe)
    # an MSRA R-101.pkl of seeded random backbone values, in place of the download
    rbackbone = build_model(rcfg, device="cpu", generator=torch.Generator().manual_seed(19))
    rpkl = write_msra_pickle(
        reference_values({k: v for k, v in rbackbone.state_dict().items()
                          if k.startswith("backbone.")}, np.random.RandomState(19)),
        os.path.join(opt_dir, "R-101.pkl"))
    del rbackbone
    r101_args = ["--config-file", r101_recipe, "SOLVER.REFERENCE_WORLD_SIZE", "0",
                 "SOLVER.IMS_PER_BATCH", str(b), "TPU.EVAL_BATCH", str(b), "SEED", str(R101_SEED),
                 "MODEL.WEIGHTS", rpkl, "DATASETS.TRAIN", "('dota_1_train_1024',)",
                 "DATASETS.TEST", "('dota_1_val_1024',)", "OUTPUT_DIR", r101_dir]
    rcfg.merge_from_list(r101_args[2:])
    rrecords = get_dataset("dota_1_train_1024", rcfg)
    rladder = train_canvas_buckets(rcfg, rrecords)
    rdraw = np.random.RandomState(R101_SEED * 7919 + 13)  # the loader's per-batch stream
    rdrawn = [rladder.draw(rdraw)[1] for _ in range(R101_STEPS)]
    A.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rtrain = {}
    t0 = time.perf_counter()
    cli_main(r101_args + ["SOLVER.MAX_ITER", str(R101_STEPS), "DATASETS.TEST", "()"],
             train_stats=rtrain)
    torch.cuda.synchronize()
    r101_train_s = time.perf_counter() - t0
    r101_k3 = A.assign_argmin_cuda.launches
    rpeak_train = torch.cuda.max_memory_allocated() / 2**30
    rsteps = rtrain["steps"]
    want_hits = {c: rdrawn.count(c) for c in set(rdrawn)}
    rlosses = [x for v in rsteps.values() for x in v["loss"]]
    if (r101_k3 != R101_STEPS or {c: len(v["ms"]) for c, v in rsteps.items()} != want_hits
            or any(v["builds"] != 1 for v in rsteps.values()) or not all(np.isfinite(rlosses))):
        raise SystemExit(f"R-101 train: K3 {r101_k3} for {R101_STEPS} steps; steps per canvas "
                         f"{ {c: len(v['ms']) for c, v in rsteps.items()} }, drawn {want_hits}; "
                         f"losses {rlosses}")
    err, rcanvases = hold_k3_on_loader(rcfg, rrecords, R101_STEPS, "R-101 train")
    max_err["assign_argmin"] = max(max_err["assign_argmin"], err)
    if rcanvases != rdrawn:
        raise SystemExit(f"R-101: the loader's canvases {rcanvases}, drawn {rdrawn}")
    rsplit = {f"{h}x{w}": {"steps": len(v["ms"]), "first_ms": round(v["ms"][0], 2),
                           "later_median_ms": (round(statistics.median(v["ms"][1:]), 2)
                                               if len(v["ms"]) > 1 else None)}
              for (h, w), v in sorted(rsteps.items())}
    log(f"[r101] CLI --config-file {R101_RECIPE}, R-101 full width, 15 classes, batch {b}, "
        f"SEED {R101_SEED}, {R101_STEPS} steps from an R-101.pkl on the ladder (h, w) "
        f"{rladder.canvases} (scales {rladder.sizes}) in {r101_train_s:.2f} s wall; canvases "
        f"drawn {rdrawn}; each canvas's step built once; step ms per canvas on CUDA events (the "
        f"first apart: the step's build; cuDNN's heuristics) {json.dumps(rsplit)}; total loss per step in canvas "
        f"order {[round(x, 4) for x in rlosses]}; K3 {r101_k3} launches, equal to its plain "
        f"version on each step's batch; peak memory {rpeak_train:.2f} GiB (max_memory_allocated) "
        f"[{card}]")
    rmodel = bias_minus_2_checkpoint(rcfg, r101_dir)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rstats, rtta = {}, {}
    reval_args = ["--eval-only"] + r101_args + ["DEBUG.OVERFIT_NUM_IMAGES", str(N_R101_EVAL),
                                                 "TEST.AUG.MIN_SIZES", R101_TTA_SIZES]
    t0 = time.perf_counter()
    rres = cli_main(reval_args, stats=rstats, tta_stats=rtta)
    torch.cuda.synchronize()
    r101_eval_s = time.perf_counter() - t0
    rpeak_eval = torch.cuda.max_memory_allocated() / 2**30
    r101_nms = {"suppression_matrix": K.suppression_bits_cuda.launches,
                "greedy_keep": K.greedy_keep_bits_cuda.launches}
    rst, rtt = rstats["dota_1_val_1024"], rtta["dota_1_val_1024"]
    tta_steps = sum(sum(p["steps"].values()) for p in rtt["per_image"])
    n_rbatches = -(-N_R101_EVAL // b)
    copies = sorted({p["copies"] for p in rtt["per_image"]})
    if (set(r101_nms.values()) != {n_rbatches + tta_steps} or rst["images"] != N_R101_EVAL
            or rtt["images"] != N_R101_EVAL or not np.isfinite(rres["tta"]["dota_1_val_1024"]["mAP"])):
        raise SystemExit(f"R-101 eval: launches {r101_nms} for {n_rbatches} batches and "
                         f"{tta_steps} TTA eval steps; images {rst['images']}, {rtt['images']}")
    revecfg = copy.deepcopy(rcfg)
    revecfg.merge_from_list(reval_args[3:])
    rval = get_dataset("dota_1_val_1024", revecfg)
    with torch.inference_mode():
        rbatch = next(iter(DataLoader(revecfg, rval, b, pad_hw=eval_pad_hw(revecfg, rval),
                                      train=False)))
        rrows = hold_nms(rmodel(rbatch["image"].cuda()), DecodeSpec.from_config(revecfg),
                         "the R-101 eval batch")
    r_tta_split = {"s_per_image": round(rtt["loop_s"] / rtt["images"], 3),
                   "wall_ms": [round(p["wall_ms"], 1) for p in rtt["per_image"]],
                   "merge_ms": [round(p["merge_ms"], 1) for p in rtt["per_image"]],
                   "eval_steps": rtt["per_image"][0]["steps"],
                   "boxes_in": [p["boxes_in"] for p in rtt["per_image"]],
                   "boxes_out": [p["boxes_out"] for p in rtt["per_image"]]}
    log(f"[r101] CLI --eval-only (class bias -2) on {N_R101_EVAL} dota_1_val_1024 tiles "
        f"(DEBUG.OVERFIT_NUM_IMAGES) in {r101_eval_s:.2f} s wall: eval loop "
        f"{rst['images'] / rst['loop_s']:.2f} img/s (host clock, the first batch pays its "
        f"shapes' first calls), mAP {rres['dota_1_val_1024'].get('mAP', float('nan')):.4f}; TTA (FLIP: HFLIP "
        f"and VFLIP, MIN_SIZES {R101_TTA_SIZES}, the recipe's 9-scale ladder cut for time, "
        f"{copies} copies per image) {json.dumps(r_tta_split)}, mAP "
        f"{rres['tta']['dota_1_val_1024']['mAP']:.4f}; K1 and greedy {r101_nms} launches, once "
        f"per eval batch and TTA eval step, equal to their plain versions on the eval batch's "
        f"NMS input (rows, valid, kept) {rrows}; peak memory {rpeak_eval:.2f} GiB [{card}]")
    r101_launches = {"suppression_matrix": r101_nms["suppression_matrix"],
                     "greedy_keep": r101_nms["greedy_keep"], "assign_argmin": r101_k3}
    del rmodel
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = benchmark
    log(f"[options] phase 17 wall time {time.perf_counter() - t17:.1f} s; launches: options "
        f"{opt_launches}, r101 {r101_launches} [{card}]")

    # ---- 18. several processes: the CLI on two ranks, elastic resume -------
    phase(18, "several processes")
    dist_launches = phase_distributed(card)

    # ---- 19. JPEG, the synthetic and ICDAR15 recipes, and the server -------
    phase(19, "JPEG, the synthetic and ICDAR15 recipes, and the server")
    p19 = phase_jpeg_recipes(card, pkl, rpkl, hold_k3_on_loader, bias_minus_2_checkpoint)

    def p19_sum(kernel):
        return sum(v.get(kernel, 0) for v in p19.values())

    # ---- 20. deformable convolution and the other backbones ---------------
    phase(20, "deformable convolution and the other backbones")
    deform, p20 = phase_backbones(card, data_dir, pkl, train_cfg, train_records,
                                  hold_k3_on_loader, bias_minus_2_checkpoint)

    def p20_sum(kernel):
        return sum(v.get(kernel, 0) for v in p20.values())

    # ---- 21. export and artifact serving ------------------------------------
    phase(21, "export and artifact serving")
    export_launches, export_op_ms = phase_export(card, bias_minus_2_checkpoint)

    # ---- 22. int8 eval -------------------------------------------------------
    phase(22, "int8 eval")
    int8_rows = phase_int8(card)

    # ---- 23. the trained-weight gates, short ---------------------------------
    phase(23, "trained-weight gates (short)")
    gates = phase_gates(card)
    for row in int8_rows:
        row["launches_by_path"].update({k: v[row["name"]] for k, v in gates.items()
                                        if k != "gate_tta"})
        row["launches"] = sum(row["launches_by_path"].values())

    # ---- 24. the measurement tools, short ------------------------------------
    phase(24, "measurement tools (short)")
    tools = phase_tools(card)

    kernels = [
        {"name": "suppression_matrix", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:164",
         "launches": launches["suppression_matrix"] + eval_launches["suppression_matrix"]
         + tta_launches["suppression_matrix"] + files_launches["suppression_matrix"]
         + hrsc_nms_launches + opt_launches["suppression_matrix"]
         + r101_launches["suppression_matrix"] + dist_launches["suppression_matrix"]
         + p19_sum("suppression_matrix") + p20_sum("suppression_matrix")
         + export_launches["suppression_matrix"]
         + sum(v["suppression_matrix"] for v in gates.values()) + tools["suppression_matrix"],
         "launches_by_path": {"inference": launches["suppression_matrix"],
                              "eval": eval_launches["suppression_matrix"],
                              "tta": tta_launches["suppression_matrix"],
                              "files": files_launches["suppression_matrix"],
                              "hrsc": hrsc_nms_launches,
                              "options": opt_launches["suppression_matrix"],
                              "r101": r101_launches["suppression_matrix"],
                              "distributed": dist_launches["suppression_matrix"],
                              **{k: v["suppression_matrix"] for k, v in p19.items()},
                              **{k: v["suppression_matrix"] for k, v in p20.items()},
                              "export_serve": export_launches["suppression_matrix"],
                              **{k: v["suppression_matrix"] for k, v in gates.items()},
                              "tools": tools["suppression_matrix"]},
         "max_abs_err": max_err["suppression_matrix"], "ms": k1_ms, "device_ms": k1_dev,
         "op_ms": k1_op_ms, "op_ms_one_request": export_op_ms["suppression_matrix"],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "greedy_keep", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:312",
         "launches": launches["greedy_keep"] + eval_launches["greedy_keep"]
         + tta_launches["greedy_keep"] + files_launches["greedy_keep"] + hrsc_nms_launches
         + opt_launches["greedy_keep"] + r101_launches["greedy_keep"]
         + dist_launches["greedy_keep"] + p19_sum("greedy_keep") + p20_sum("greedy_keep")
         + export_launches["greedy_keep"] + sum(v["greedy_keep"] for v in gates.values())
         + tools["greedy_keep"],
         "launches_by_path": {"inference": launches["greedy_keep"],
                              "eval": eval_launches["greedy_keep"],
                              "tta": tta_launches["greedy_keep"],
                              "files": files_launches["greedy_keep"],
                              "hrsc": hrsc_nms_launches,
                              "options": opt_launches["greedy_keep"],
                              "r101": r101_launches["greedy_keep"],
                              "distributed": dist_launches["greedy_keep"],
                              **{k: v["greedy_keep"] for k, v in p19.items()},
                              **{k: v["greedy_keep"] for k, v in p20.items()},
                              "export_serve": export_launches["greedy_keep"],
                              **{k: v["greedy_keep"] for k, v in gates.items()},
                              "tools": tools["greedy_keep"]},
         "max_abs_err": max_err["greedy_keep"], "ms": g_ms, "device_ms": g_dev,
         "op_ms": g_op_ms, "op_ms_one_request": export_op_ms["greedy_keep"],
         "plain_ms": g_plain_ms, "bound_ms": g_bound, "bound_by": g_by, "library_ms": None},
        {"name": "assign_argmin", "route": "cuda", "source": "dafne_torch/csrc/assign.cu",
         "replaces": "dafne_tpu/ops/pallas/assign.py:35",
         "launches": train_launches + da_launches + files_launches["assign_argmin"] + hrsc_k3
         + opt_launches["assign_argmin"] + r101_launches["assign_argmin"]
         + dist_launches["assign_argmin"] + p19_sum("assign_argmin") + p20_sum("assign_argmin")
         + sum(v["assign_argmin"] for v in gates.values()) + tools["assign_argmin"],
         "launches_by_path": {"train": train_launches, "train_device_aug": da_launches,
                              "files": files_launches["assign_argmin"], "hrsc": hrsc_k3,
                              "options": opt_launches["assign_argmin"],
                              "r101": r101_launches["assign_argmin"],
                              "distributed": dist_launches["assign_argmin"],
                              **{k: v["assign_argmin"] for k, v in p19.items()
                                 if "assign_argmin" in v},
                              **{k: v["assign_argmin"] for k, v in p20.items()},
                              **{k: v["assign_argmin"] for k, v in gates.items()},
                              "tools": tools["assign_argmin"]},
         "max_abs_err": max_err["assign_argmin"], "ms": k3_ms, "device_ms": k3_dev,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "suppression_matrix_2d", "route": "cuda", "source": "dafne_torch/csrc/quad_nms.cu",
         "replaces": "dafne_tpu/ops/pallas/quad_nms.py:128",
         "launches": k2_launches + tools["suppression_matrix_2d"],
         "launches_by_path": {"eval_replay": k2_launches, "tools": tools["suppression_matrix_2d"]},
         "max_abs_err": max_err["suppression_matrix_2d"], "ms": k2_ms, "device_ms": k2_dev,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        *({"name": name, "route": "cuda", "source": "dafne_torch/csrc/deform_conv.cu",
           "replaces": "dafne_tpu/layers/deform_conv.py:26 (XLA gathers; no Pallas kernel)",
           "launches": p20_sum(name),
           "launches_by_path": {k: v[name] for k, v in p20.items() if name in v},
           **deform[part]}
          for name, part in (("deform_im2col", "forward"),
                             ("deform_im2col_backward", "backward"))),
        *int8_rows,
    ]
    phase(None, "report")
    log(f"[phases] wall seconds per phase (host clock; 0 is the imports) "
        f"{json.dumps(PHASE_S)}, in all {sum(PHASE_S.values()):.1f} [{card}]")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
