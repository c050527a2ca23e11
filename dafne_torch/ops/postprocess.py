"""Fixed-size decoding of dense head outputs into detections.

Counterpart of ``dafne_tpu/ops/postprocess.py``:

  per level:   sigmoid(cls) [, sqrt(cls*ctr)] -> threshold mask
               -> top-k over the flattened (location x class) axis
               -> corners = location + stride * offsets
  all levels:  concat -> global score cap to NMS_MAX_CANDIDATES (none on
               the grouped path) -> canonical corner sort -> rotated NMS
               (global, or per class group when NMS_GROUP_CANDIDATES > 0)
               -> post-NMS top-k

Every output has a fixed size and a validity mask.  Each top-k takes the
same set and the same order as the JAX function (``ops/topk.py``), so the
NMS sees its candidates in the same order and ties resolve alike.
``TPU.DECODE_APPROX_TOPK`` (the JAX package's approximate top-k) is not
ported: ``DecodeSpec.from_config`` raises when it is set.  ``skip_nms``
is JAX's diagnostic (``dafne_tpu/ops/postprocess.py:53,228``): keep =
valid, the same program without suppression, which the profiler's
``eval_roofline`` differences against the full one; never a serving mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from dafne_torch.geometry.quads import enclosing_hbox, sort_quadrilateral
from dafne_torch.ops.nms import rotated_nms, rotated_nms_grouped_batched
from dafne_torch.ops.topk import exact_topk_set, top_k


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    num_classes: int = 15
    pre_nms_thresh: float = 0.05
    pre_nms_topk: int = 2000
    post_nms_topk: int = 1000
    nms_threshold: float = 0.1
    thresh_with_ctr: bool = False
    has_centerness: bool = True
    ctr_in_score: bool = True
    sort_corners: bool = True
    stride_norm: bool = True
    nms_max_candidates: int = 2048
    nms_group_candidates: int = 0  # > 0: per-class-group NMS with this budget
    # (ops/nms.py::rotated_nms_grouped_batched); 0: the global-cap path
    class_merge: Tuple[Tuple[int, int], ...] = ((5, 4),)
    skip_nms: bool = False  # diagnostic only: keep = valid (no suppression)

    @classmethod
    def from_config(cls, cfg, train: bool = False) -> "DecodeSpec":
        """Decode settings of a config, at test time unless `train`."""
        if cfg.TPU.DECODE_APPROX_TOPK:
            raise NotImplementedError("TPU.DECODE_APPROX_TOPK (approximate top-k) is not ported")
        d = cfg.MODEL.DAFNE
        return cls(
            strides=tuple(d.FPN_STRIDES),
            num_classes=d.NUM_CLASSES,
            pre_nms_thresh=d.INFERENCE_TH_TRAIN if train else d.INFERENCE_TH_TEST,
            pre_nms_topk=d.PRE_NMS_TOPK_TRAIN if train else d.PRE_NMS_TOPK_TEST,
            post_nms_topk=d.POST_NMS_TOPK_TRAIN if train else d.POST_NMS_TOPK_TEST,
            nms_threshold=d.NMS_TH,
            thresh_with_ctr=d.THRESH_WITH_CTR,
            has_centerness=d.CENTERNESS != "none",
            ctr_in_score=d.CENTERNESS_USE_IN_SCORE,
            sort_corners=d.SORT_CORNERS,
            stride_norm=d.ENABLE_FPN_STRIDE_NORM,
            nms_max_candidates=cfg.TPU.NMS_MAX_CANDIDATES,
            nms_group_candidates=cfg.TPU.get("NMS_GROUP_CANDIDATES", 0),
        )


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [N, M, ...] gathered along axis 1 by idx [N, k]."""
    idx = idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(idx.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def decode_single_level(logits, corners, ctrness, stride: int, spec: DecodeSpec):
    """Top-k decode of one FPN level: logits [N, H, W, C], corners
    [N, H, W, 8], ctrness [N, H, W, 1] -> dict of [N, k] candidates."""
    n, h, w, c = logits.shape
    hw = h * w
    k = min(spec.pre_nms_topk, hw * c)

    cls_prob = torch.sigmoid(logits.reshape(n, hw, c))
    ctr_prob = ctrness.reshape(n, hw)
    if spec.has_centerness:
        ctr_prob = torch.sigmoid(ctr_prob)

    # centerness is always mixed into the NMS score when enabled;
    # CENTERNESS_USE_IN_SCORE=False only un-mixes the reported score
    if spec.has_centerness and spec.thresh_with_ctr:
        cls_prob = torch.sqrt(cls_prob * ctr_prob[:, :, None])
    candidate = cls_prob > spec.pre_nms_thresh
    if spec.has_centerness and not spec.thresh_with_ctr:
        cls_prob = torch.sqrt(cls_prob * ctr_prob[:, :, None])

    flat = torch.where(candidate, cls_prob, 0.0).reshape(n, hw * c)
    if hw * c > 4 * k:
        top_scores, top_idx = exact_topk_set(flat, k)
    else:
        top_scores, top_idx = top_k(flat, k)
    loc_idx = top_idx // c
    cls_idx = (top_idx % c).to(torch.int32)

    sel_reg = _take(corners.reshape(n, hw, 8), loc_idx)
    if spec.stride_norm:
        sel_reg = sel_reg * stride
    lx = (loc_idx % w).to(torch.float32) * stride + stride // 2
    ly = (loc_idx // w).to(torch.float32) * stride + stride // 2
    sel_loc = torch.stack([lx, ly], dim=-1)  # [N, k, 2]
    return {
        "corners": sel_reg + sel_loc.repeat(1, 1, 4),
        "scores": top_scores,
        "classes": cls_idx,
        "centerness": torch.gather(ctr_prob, 1, loc_idx),
        "locations": sel_loc,
        "valid": top_scores > 0.0,
    }


def nms_candidates(head_out: Dict[str, List[torch.Tensor]], spec: DecodeSpec):
    """Per-level top-k, concat, global score cap (none on the grouped path:
    every per-level survivor enters NMS) and corner sort: the NMS input.
    Returns a dict of [N, m] arrays (corners [N, m, 8] sorted)."""
    per_level = [
        decode_single_level(
            head_out["logits"][i], head_out["corners"][i], head_out["ctrness"][i],
            spec.strides[i], spec,
        )
        for i in range(len(head_out["logits"]))
    ]
    cand = {key: torch.cat([p[key] for p in per_level], dim=1) for key in per_level[0]}

    total = cand["scores"].shape[1]
    masked = torch.where(cand["valid"], cand["scores"], 0.0)
    keys = ("corners", "classes", "centerness", "locations")
    if spec.nms_group_candidates > 0:
        # the grouped NMS takes its own per-group top-k and the post-NMS
        # top-k orders the output, so no global cap and no global top-k
        out = {key: cand[key] for key in keys}
        scores = masked
    else:
        m = min(spec.nms_max_candidates, total) if spec.nms_max_candidates > 0 else total
        if m < total and total > 2048:
            scores, idx = exact_topk_set(masked, m)
        else:
            scores, idx = top_k(masked, m)
        out = {key: _take(cand[key], idx) for key in keys}
    out["scores"] = scores
    out["valid"] = scores > 0.0
    if spec.sort_corners:
        out["corners"] = sort_quadrilateral(out["corners"])
    return out


def decode_detections(head_out: Dict[str, List[torch.Tensor]], spec: DecodeSpec,
                      scale_xy: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Full decode: per-level top-k -> concat -> [cap ->] NMS -> post-NMS top-k.

    Returns [N, post_nms_topk] arrays: corners [.., 8] (in original image
    coordinates if scale_xy [N, 2] is given), hboxes [.., 4], scores,
    classes, centerness, locations, valid."""
    cand = nms_candidates(head_out, spec)
    if spec.skip_nms:
        keep = cand["valid"]
    elif spec.nms_group_candidates > 0:
        keep = rotated_nms_grouped_batched(
            cand["corners"], cand["scores"], cand["classes"], cand["valid"],
            spec.nms_threshold, spec.class_merge, spec.num_classes,
            group_k=spec.nms_group_candidates,
            min_total=max(spec.nms_max_candidates, spec.post_nms_topk),
        )
    else:
        keep = rotated_nms(
            cand["corners"], cand["scores"], cand["classes"], cand["valid"],
            spec.nms_threshold, spec.class_merge, scores01=True,  # sqrt(cls*ctr)
        )

    m = cand["scores"].shape[1]
    out_scores, out_idx = top_k(torch.where(keep, cand["scores"], 0.0), min(spec.post_nms_topk, m))
    out = {key: _take(cand[key], out_idx) for key in ("corners", "classes", "centerness", "locations")}
    out["scores"] = out_scores
    out["valid"] = out_scores > 0.0
    if spec.has_centerness and not spec.ctr_in_score:
        # the reported score reverts to the class confidence s^2 / ctr
        out["scores"] = torch.where(
            out["valid"], out_scores * out_scores / torch.clamp(out["centerness"], min=1e-12), 0.0
        )
    if scale_xy is not None:
        out["corners"] = out["corners"] * scale_xy.repeat(1, 4)[:, None, :]
        out["locations"] = out["locations"] * scale_xy[:, None, :]
    out["hboxes"] = enclosing_hbox(out["corners"])
    return out
