"""VOC-style rotated AP with exact polygon IoU.

The port's own copy of ``dafne_tpu/evaluation/voc_eval.py`` (``voc_ap``,
``_hbb``, ``eval_class``): detections and ground truth as arrays.  Matching
rules:
  - detections sorted by confidence (descending);
  - an axis-aligned prefilter with the +1-pixel VOC convention; only gts
    with hbb overlap > 0 get the exact polygon IoU;
  - a detection is a TP iff its max exact IoU > ovthresh (strict) against an
    unmatched, non-difficult gt; a match to a difficult gt is neither TP nor
    FP;
  - npos counts non-difficult gts only;
  - VOC-07 11-point AP by default.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from dafne_torch.utils.polyiou import iou_poly_pairs


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = True) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(prec[rec >= t])) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _hbb(c: np.ndarray) -> np.ndarray:
    """[N, 8] -> [N, 4] xmin,ymin,xmax,ymax."""
    return np.stack(
        [
            c[:, 0::2].min(1), c[:, 1::2].min(1),
            c[:, 0::2].max(1), c[:, 1::2].max(1),
        ],
        axis=1,
    )


def eval_class(
    det_image_ids: Sequence[str],
    det_scores: np.ndarray,
    det_corners: np.ndarray,
    gt_by_image: Dict[str, Tuple[np.ndarray, np.ndarray]],
    ovthresh: float = 0.5,
    use_07_metric: bool = True,
):
    """Evaluate one class.

    det_*: all detections of this class across the dataset.
    gt_by_image: image_id -> (corners [M, 8] float64, difficult [M] bool)
    Returns (rec, prec, ap, scores_overlap list).
    """
    npos = sum(int((~d).sum()) for _, d in gt_by_image.values())
    matched = {k: np.zeros(len(v[0]), bool) for k, v in gt_by_image.items()}

    order = np.argsort(-np.asarray(det_scores))
    nd = len(order)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    scores_overlap: List[list] = []

    for rank, d in enumerate(order):
        img = det_image_ids[d]
        bb = np.asarray(det_corners[d], np.float64)
        conf = float(det_scores[d])
        gt = gt_by_image.get(img)
        ovmax, jmax = -np.inf, -1
        if gt is not None and len(gt[0]) > 0:
            gtc = np.asarray(gt[0], np.float64)
            ghbb = _hbb(gtc)
            bx0, by0 = bb[0::2].min(), bb[1::2].min()
            bx1, by1 = bb[0::2].max(), bb[1::2].max()
            iw = np.maximum(
                np.minimum(ghbb[:, 2], bx1) - np.maximum(ghbb[:, 0], bx0) + 1.0, 0.0
            )
            ih = np.maximum(
                np.minimum(ghbb[:, 3], by1) - np.maximum(ghbb[:, 1], by0) + 1.0, 0.0
            )
            inter = iw * ih
            uni = (
                (bx1 - bx0 + 1.0) * (by1 - by0 + 1.0)
                + (ghbb[:, 2] - ghbb[:, 0] + 1.0) * (ghbb[:, 3] - ghbb[:, 1] + 1.0)
                - inter
            )
            keep = np.where(inter / uni > 0)[0]
            if len(keep):
                ious = iou_poly_pairs(
                    np.broadcast_to(bb, (len(keep), 8)), gtc[keep]
                )
                j = int(np.argmax(ious))
                ovmax = float(ious[j])
                jmax = int(keep[j])
        if ovmax > ovthresh:
            difficult = gt_by_image[img][1]
            if not difficult[jmax]:
                if not matched[img][jmax]:
                    tp[rank] = 1.0
                    matched[img][jmax] = True
                    scores_overlap.append([conf, ovmax, 1])
                else:
                    fp[rank] = 1.0
                    scores_overlap.append([conf, ovmax, 0])
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(float(npos), np.finfo(np.float64).eps)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap, scores_overlap
