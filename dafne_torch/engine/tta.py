"""Test-time augmentation (TTA) evaluation.

Counterpart of ``dafne_tpu/engine/tta.py`` (:46-296):

- the copies of an image are {TEST.AUG.MIN_SIZES shortest-edge resizes} x
  {identity, hflip, vflip, or ROTATION_ANGLES with hflip}
  (``build_tta_augs``);
- each copy renders onto the smallest canvas of a ladder that holds it
  (``_CANVAS_LADDER``, rounded to TPU.IMAGE_SIZE_DIVISIBILITY, capped at
  TEST.AUG.MAX_SIZE), with an eval step per canvas whose batch keeps
  batch x canvas area within 4 x 1024^2 (at most 8); a short group is
  padded by repeating its last copy (``BucketedEvalSteps``);
- with TPU.TTA_DEVICE_AUG the image goes to the device once, padded to
  the rounded base canvas, and every separable copy is rendered there from
  it (``ops/device_warp.py``), a group of copies with one transpose and one
  canvas at a time (``BucketedEvalSteps.get_fused``);
- the other copies (a TEST.AUG.ROTATION_ANGLES entry that is not a multiple
  of 90 degrees), and every copy without TPU.TTA_DEVICE_AUG, render on the
  host with ``AffineAug.apply_image`` (``data/image_warp.py``, cv2's bytes)
  onto a uint8 canvas, top-left, grouped by the smallest canvas that holds
  them (``BucketedEvalSteps.get``, JAX :174-235);
- detected corners map back with the exact inverse affine in float64, and
  all copies merge by class-aware polygon NMS (class 5 merged into 4,
  ``utils/polyiou.py::poly_nms``) and a post-NMS top-k
  (``tta_inference_single``); ``do_test_with_tta`` scores every
  DATASETS.TEST dataset into OUTPUT_DIR/inference_tta/<dataset>, decoding
  a record's file (``data/image_io.py::read_image``, :282-283) where it
  carries no image.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dafne_torch.data import get_dataset
from dafne_torch.data import transforms as T
from dafne_torch.data.image_io import read_image
from dafne_torch.engine.events import elapsed_ms, mark
from dafne_torch.engine.inference import make_eval_step
from dafne_torch.evaluation import build_evaluator
from dafne_torch.ops.device_warp import (
    device_warp,
    separable_warp_params,
    stack_warps,
    warp_tensors,
)
from dafne_torch.utils.polyiou import poly_nms

logger = logging.getLogger("dafne_torch")

FETCH_KEYS = ("corners", "scores", "classes", "valid")


def build_tta_augs(cfg, w: int, h: int) -> List[T.AffineAug]:
    """The copies of a w x h image, in the JAX package's order."""
    augs = []
    max_size = cfg.TEST.AUG.MAX_SIZE
    rotations = list(cfg.TEST.AUG.ROTATION_ANGLES)
    for min_size in cfg.TEST.AUG.MIN_SIZES:
        base = T.shortest_edge_resize(w, h, int(min_size), max_size)
        variants = [base]
        if rotations:
            for ang in rotations:
                variants.append(T.rotation(w, h, float(ang)).compose(base))
                if cfg.TEST.AUG.HFLIP:
                    variants.append(
                        T.rotation(w, h, float(ang)).compose(T.hflip(w, h).compose(base)))
        else:
            if cfg.TEST.AUG.HFLIP:
                variants.append(T.hflip(w, h).compose(base))
            if cfg.TEST.AUG.VFLIP:
                variants.append(T.vflip(w, h).compose(base))
        augs.extend(variants)
    return augs


# canvas sides of the eval steps, rounded up to the divisibility at use
_CANVAS_LADDER = (
    128, 256, 384, 512, 640, 768, 896, 1024, 1280, 1536, 1792, 2048,
    2560, 3072, 3584, 4096,
)


class BucketedEvalSteps:
    """Eval steps of `model` (on its device), one per ladder canvas for
    host-rendered copies and one per (base canvas, ladder canvas,
    transpose) for device-rendered ones, built on first use."""

    def __init__(self, cfg, model, max_batch: int = 8, area_budget: int = 4 * 1024 * 1024):
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.div = max(int(cfg.TPU.IMAGE_SIZE_DIVISIBILITY), 1)
        self.max_size = int(-(-int(cfg.TEST.AUG.MAX_SIZE) // self.div) * self.div)
        self.max_batch = max_batch
        self.area_budget = area_budget
        self._steps = {}

    def _canvas_for(self, needed: int) -> int:
        for c in _CANVAS_LADDER:
            c = int(-(-c // self.div) * self.div)
            if needed <= c <= self.max_size:
                return c
        # a copy larger than MAX_SIZE renders cropped onto the largest canvas
        return self.max_size

    def _batch(self, side: int) -> int:
        return int(min(self.max_batch, max(1, self.area_budget // (side * side))))

    def get(self, needed_hw):
        """(canvas_hw, step, batch) for host-rendered copies that need
        `needed_hw`: ``step(images [batch, side, side, 3])``."""
        side = self._canvas_for(max(needed_hw))
        if side not in self._steps:
            self._steps[side] = (make_eval_step(self.model, self.cfg, (side, side)),
                                 self._batch(side))
            logger.info(f"TTA: eval step for canvas {side}, batch {self._steps[side][1]}")
        step, batch = self._steps[side]
        return (side, side), step, batch

    def get_fused(self, base_hw, needed_hw, transpose: bool):
        """(canvas_hw, step, batch) for copies of a `base_hw` base image
        that need `needed_hw`: ``step(base_img, warps, marks=None)`` renders
        the copies (``device_warp``, `transpose`) and runs the canvas's eval
        step on them; with a `marks` list it appends a ``mark`` between
        the two."""
        side = self._canvas_for(max(needed_hw))
        key = (tuple(base_hw), side, transpose)
        if key not in self._steps:
            batch = self._batch(side)
            eval_core = make_eval_step(self.model, self.cfg, (side, side))

            def fused(base_img, warps, marks: Optional[list] = None):
                images = device_warp(base_img, warps, transpose)
                if marks is not None:
                    marks.append(mark(images.device))
                return eval_core(images)

            self._steps[key] = (fused, batch)
            logger.info(f"TTA: eval step for base {tuple(base_hw)}, canvas {side}, "
                        f"transpose {transpose}, batch {batch}")
        step, batch = self._steps[key]
        return (side, side), step, batch


def tta_inference_single(cfg, steps: BucketedEvalSteps, img: np.ndarray,
                         stats: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """Every TTA copy of `img` [H, W, 3] through `steps`, merged: corners
    [D, 8] in `img`'s coordinates, scores, classes and valid.  A `stats`
    dict receives the copies (and those rendered on the host), the steps
    and the milliseconds of the device warp and of the eval steps per
    canvas (on the step's device: CUDA events on the card), of the host
    warps, of the fetch, of the merge and of the whole call (host clock),
    and the boxes into and out of the merge."""
    t_call = time.perf_counter()
    h, w = img.shape[:2]
    augs = build_tta_augs(cfg, w, h)
    groups: Dict[tuple, list] = {}
    host_augs = augs
    if cfg.TPU.TTA_DEVICE_AUG:
        host_augs = []
        for aug in augs:
            side = steps._canvas_for(max(aug.out_h, aug.out_w))
            p = separable_warp_params(aug, w, h, (side, side))
            if p is None:
                host_augs.append(aug)  # an arbitrary angle: the host warp
            else:
                groups.setdefault((side, p.transpose), []).append((aug, p))

    device = steps.device
    st = {"copies": len(augs), "host_copies": len(host_augs), "steps": {}, "warp_ms": 0.0,
          "host_warp_ms": 0.0, "eval_ms": {}, "fetch_ms": 0.0}
    parts = []

    def run(side, call, chunk_augs, marks):
        """One eval step over a padded chunk; its detections mapped back."""
        det = call()
        if stats is not None:
            marks.append(mark(device))
            t0 = time.perf_counter()
        det = {k: det[k].cpu().numpy() for k in FETCH_KEYS}
        if stats is not None:
            st["fetch_ms"] += (time.perf_counter() - t0) * 1e3
            st["eval_ms"][side] = st["eval_ms"].get(side, 0.0) + elapsed_ms(*marks[-2:])
            st["steps"][side] = st["steps"].get(side, 0) + 1
        for i, aug in enumerate(chunk_augs):
            m = det["valid"][i]
            corners = det["corners"][i][m].astype(np.float64)
            parts.append((aug.invert_coords(corners.reshape(-1, 4, 2)).reshape(-1, 8),
                          det["scores"][i][m], det["classes"][i][m]))

    if groups:
        rup = lambda v: int(-(-v // steps.div) * steps.div)  # noqa: E731
        base_hw = (rup(h), rup(w))
        base = np.zeros(base_hw + (3,), np.uint8 if img.dtype == np.uint8 else np.float32)
        base[:h, :w] = img
        base_dev = torch.from_numpy(base).to(device)
    for (side, transpose), items in groups.items():
        _, step, batch = steps.get_fused(base_hw, (side, side), transpose)
        for start in range(0, len(items), batch):
            chunk = items[start:start + batch]
            real = len(chunk)
            chunk = chunk + [chunk[-1]] * (batch - real)  # pad by repeating the last copy
            warps = warp_tensors(stack_warps([p for _, p in chunk]), device)
            marks = [mark(device)] if stats is not None else None
            run(side, lambda: step(base_dev, warps, marks), [a for a, _ in chunk[:real]], marks)
            if stats is not None:
                st["warp_ms"] += elapsed_ms(marks[0], marks[1])

    # host-rendered copies, grouped by the smallest canvas that holds them
    by_canvas: Dict[tuple, list] = {}
    for aug in host_augs:
        by_canvas.setdefault(steps.get((aug.out_h, aug.out_w)), []).append(aug)
    for ((pad_h, pad_w), step, batch), items in by_canvas.items():
        t0 = time.perf_counter()
        canvases = np.zeros((len(items), pad_h, pad_w, 3), np.uint8)
        for canvas, aug in zip(canvases, items):
            warped = aug.apply_image(img)
            canvas[:warped.shape[0], :warped.shape[1]] = warped[:pad_h, :pad_w]
        st["host_warp_ms"] += (time.perf_counter() - t0) * 1e3
        for start in range(0, len(items), batch):
            idx = list(range(start, min(start + batch, len(items))))
            idx += [idx[-1]] * (batch - len(idx))  # pad by repeating the last copy
            images = torch.from_numpy(canvases[idx]).to(device)
            marks = [mark(device)] if stats is not None else None
            run(pad_h, lambda: step(images), items[start:start + batch], marks)

    t0 = time.perf_counter()
    corners = np.concatenate([c for c, _, _ in parts]) if parts else np.zeros((0, 8))
    scores = np.concatenate([s for _, s, _ in parts]) if parts else np.zeros(0)
    classes = np.concatenate([k for _, _, k in parts]) if parts else np.zeros(0, np.int64)
    # class-aware rotated NMS over all copies, DOTA's class 5 merged into 4
    merged_cls = classes.copy()
    merged_cls[merged_cls == 5] = 4
    keep = np.zeros(len(scores), bool)
    for c in np.unique(merged_cls):
        sel = np.where(merged_cls == c)[0]
        keep[sel[poly_nms(corners[sel], scores[sel], cfg.MODEL.DAFNE.NMS_TH)]] = True
    idx = np.where(keep)[0]
    topk = cfg.MODEL.DAFNE.POST_NMS_TOPK_TEST
    if len(idx) > topk:
        idx = idx[np.argsort(-scores[idx])[:topk]]
    if stats is not None:
        now = time.perf_counter()
        st.update(merge_ms=(now - t0) * 1e3, wall_ms=(now - t_call) * 1e3, boxes_in=len(scores),
                  boxes_out=len(idx))
        stats.update(st)
    return {"corners": corners[idx], "scores": scores[idx], "classes": classes[idx],
            "valid": np.ones(len(idx), bool)}


def do_test_with_tta(cfg, model, output_dir=None, stats: Optional[dict] = None):
    """TTA evaluation of `model` (on its device) on every cfg.DATASETS.TEST
    dataset: {dataset: {"AP50/<class>": ..., "mAP": ...}}.  With
    `output_dir`, each dataset's artifacts go to
    output_dir/inference_tta/<dataset>.  A `stats` dict receives, per
    dataset, the images, the host seconds of the loop and of
    ``evaluate()``, each image's ``tta_inference_single`` stats
    ("per_image") and the detections ("preds")."""
    was_training = model.training
    model.eval()
    results = {}
    steps = BucketedEvalSteps(cfg, model)
    for dataset_name in cfg.DATASETS.TEST:
        records = get_dataset(dataset_name, cfg)
        out_dir = os.path.join(output_dir, "inference_tta", dataset_name) if output_dir else None
        evaluator = build_evaluator(cfg, dataset_name, records, out_dir)
        per_image = []
        t0 = time.perf_counter()
        for r in records:
            img = r["image"] if "image" in r else read_image(r["file_name"], cfg.INPUT.FORMAT)
            st = {} if stats is not None else None
            det = tta_inference_single(cfg, steps, img, st)
            evaluator.process_image(r["image_id"], det["corners"], det["scores"],
                                    det["classes"], det["valid"])
            per_image.append(st)
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = evaluator.evaluate()
        evaluate_s = time.perf_counter() - t0
        logger.info(f"TTA eval {dataset_name}: {len(records)} images in {loop_s:.3f} s; "
                    f"evaluate {evaluate_s:.3f} s; mAP={res.get('mAP', 0):.2f}")
        results[dataset_name] = res
        if stats is not None:
            stats[dataset_name] = {"images": len(records), "loop_s": loop_s,
                                   "evaluate_s": evaluate_s, "per_image": per_image,
                                   "preds": evaluator._preds}
    model.train(was_training)
    return results
