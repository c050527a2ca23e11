"""Rotated-detection evaluator.

The port's own copy of ``dafne_tpu/evaluation/evaluator.py``: ground truth
comes from the registered dataset records (corners and difficult flags), so
one evaluator covers every dataset; class names come from the metadata.
Outputs are the JAX package's: ``Task1_<class>.txt`` detection files
("img_id score x0 y0 ... y3"), per-class AP at TEST.IOU_TH with the VOC-07
11-point metric, ``results.txt``, ``scores_overlap.csv`` and, where
matplotlib is installed, PR-curve images.  ``render_samples`` (sample
renderings, which need cv2) is not ported.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from dafne_torch.data.registry import MetadataCatalog
from dafne_torch.evaluation.voc_eval import eval_class


class RotatedDetectionEvaluator:
    """Accumulates per-image detections on host, then computes rotated mAP."""

    def __init__(
        self,
        dataset_name: str,
        records: List[dict],
        class_names: Optional[List[str]] = None,
        iou_thresh: float = 0.5,
        use_07_metric: bool = True,
        output_dir: Optional[str] = None,
    ):
        self.dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name, {})
        self.class_names = class_names or meta.get("thing_classes") or []
        self.iou_thresh = iou_thresh
        self.use_07_metric = use_07_metric
        self.output_dir = output_dir
        self.records = records
        self.reset()

    def reset(self):
        self._preds: Dict[str, dict] = {}

    def process_image(
        self,
        image_id: str,
        corners: np.ndarray,  # [K, 8] in ORIGINAL image coordinates
        scores: np.ndarray,  # [K]
        classes: np.ndarray,  # [K]
        valid: np.ndarray,  # [K] bool
    ):
        m = np.asarray(valid, bool)
        self._preds[str(image_id)] = {
            "corners": np.asarray(corners, np.float64)[m],
            "scores": np.asarray(scores, np.float64)[m],
            "classes": np.asarray(classes, np.int64)[m],
        }

    def process_batch(self, batch: dict, decoded: dict):
        """Consume one eval batch + its decoded (host numpy) detections."""
        bv = batch.get("batch_valid")
        for i, image_id in enumerate(batch["image_id"]):
            if bv is not None and not bv[i]:
                continue
            self.process_image(
                image_id,
                decoded["corners"][i],
                decoded["scores"][i],
                decoded["classes"][i],
                decoded["valid"][i],
            )

    # ------------------------------------------------------------------ io
    def write_task1_files(self, out_dir: str):
        """Per-class DOTA Task1 detection files (dota_evaluation.py:110-164)."""
        os.makedirs(out_dir, exist_ok=True)
        per_class: Dict[int, list] = defaultdict(list)
        for image_id, p in self._preds.items():
            for c, s, box in zip(p["classes"], p["scores"], p["corners"]):
                per_class[int(c)].append((image_id, float(s), box))
        paths = {}
        for ci, name in enumerate(self.class_names):
            path = os.path.join(out_dir, f"Task1_{name}.txt")
            with open(path, "w") as f:
                for image_id, s, box in per_class.get(ci, []):
                    coords = " ".join(f"{v:.2f}" for v in box)
                    f.write(f"{image_id} {s:.4f} {coords}\n")
            paths[name] = path
        return paths

    # ------------------------------------------------------------ evaluate
    def evaluate(self) -> Dict[str, float]:
        # ground truth per class per image from the dataset records,
        # DEDUPLICATED by image_id: the *_mini splits sample records WITH
        # replacement (dota.py:312-318), and the reference's evaluators key
        # ground truth per image name (parse_gt), so a duplicated record
        # must not double its annotations / npos
        gt: Dict[int, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
        seen_images = set()
        for r in self.records:
            img = str(r["image_id"])
            if img in seen_images:
                continue
            seen_images.add(img)
            for a in r.get("annotations", []):
                gt[a["category_id"]][img].append(
                    (np.asarray(a["corners"], np.float64), bool(a.get("difficult")))
                )

        results: Dict[str, float] = {}
        aps = []
        self.scores_overlap: List[list] = []
        self.pr_curves: Dict[str, tuple] = {}
        for ci, name in enumerate(self.class_names):
            det_ids, det_scores, det_corners = [], [], []
            for image_id, p in self._preds.items():
                sel = p["classes"] == ci
                det_ids += [image_id] * int(sel.sum())
                det_scores.append(p["scores"][sel])
                det_corners.append(p["corners"][sel])
            det_scores = np.concatenate(det_scores) if det_scores else np.zeros(0)
            det_corners = (
                np.concatenate(det_corners) if det_corners else np.zeros((0, 8))
            )
            gt_by_image = {
                img: (
                    np.stack([g[0] for g in objs]),
                    np.asarray([g[1] for g in objs], bool),
                )
                for img, objs in gt[ci].items()
            }
            if len(det_ids) == 0 or not gt_by_image:
                ap = 0.0
                rec = prec = np.zeros(0)
                so = []
            else:
                rec, prec, ap, so = eval_class(
                    det_ids, det_scores, det_corners, gt_by_image,
                    self.iou_thresh, self.use_07_metric,
                )
            ap_key = f"AP{int(round(self.iou_thresh * 100))}"
            results[f"{ap_key}/{name}"] = ap * 100.0
            self.pr_curves[name] = (rec, prec)
            self.scores_overlap += [[*row, name] for row in so]
            aps.append(ap)
        results["mAP"] = float(np.mean(aps) * 100.0) if aps else 0.0

        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            self.write_task1_files(os.path.join(self.output_dir, "task1"))
            with open(os.path.join(self.output_dir, "results.txt"), "w") as f:
                for k, v in results.items():
                    f.write(f"{k}: {v:.4f}\n")
            try:
                import csv

                with open(
                    os.path.join(self.output_dir, "scores_overlap.csv"), "w"
                ) as f:
                    w = csv.writer(f)
                    w.writerow(["confidence", "overlap", "is_tp", "class"])
                    w.writerows(self.scores_overlap)
            except Exception:
                pass
            self._write_pr_curves()
        return results

    def _write_pr_curves(self):
        """Per-class precision-recall PNGs (dota_evaluation.py:167-177)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        out = os.path.join(self.output_dir, "pr_curves")
        os.makedirs(out, exist_ok=True)
        for name, (rec, prec) in self.pr_curves.items():
            if len(rec) == 0:
                continue
            fig, ax = plt.subplots(figsize=(4, 4))
            ax.plot(rec, prec)
            ax.set_xlabel("recall")
            ax.set_ylabel("precision")
            ax.set_xlim(0, 1)
            ax.set_ylim(0, 1.02)
            ax.set_title(name)
            fig.tight_layout()
            fig.savefig(os.path.join(out, f"pr_{name}.png"), dpi=100)
            plt.close(fig)


def build_evaluator(cfg, dataset_name: str, records: List[dict], output_dir=None):
    meta = MetadataCatalog.get(dataset_name, {})
    return RotatedDetectionEvaluator(
        dataset_name,
        records,
        class_names=meta.get("thing_classes"),
        iou_thresh=cfg.TEST.IOU_TH,
        use_07_metric=True,
        output_dir=output_dir,
    )
