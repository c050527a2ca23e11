"""DAFNe losses: dense, mask-weighted, in float32.

Counterpart of ``dafne_tpu/ops/losses.py``: ``sigmoid_focal_loss`` (:32),
``smooth_l1`` (:46), ``modulated_eight_point_loss`` (:54),
``plain_eight_point_loss`` (:75), ``bce_with_logits`` (:82),
``rotated_iou_loss`` (:88), ``LossSpec`` (:117) and ``dafne_losses`` (:174).
Every term is computed over all [N, K] locations and weighted by the
positive mask; sums run over the whole batch (the reference's
``dafne_outputs.py:620-731``).  With several processes each holds its rows
of the global batch: the normalizers ``num_pos`` and ``loss_denorm`` are
summed over the processes before their clamps (``all_reduce_sum``, no
gradient), so each process's loss is its local numerator over the global
normalizer and the sum over the processes is JAX's global loss.

Gradients follow JAX's at ties: ``torch.maximum``/``torch.minimum`` (not
``relu`` or ``clamp``) split the gradient in half between equal arguments,
as ``jnp.maximum``/``jnp.minimum`` do, and ``abs`` has gradient 0 at 0 in
both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dafne_torch.geometry.iou import quad_intersection_area_clip
from dafne_torch.geometry.quads import (
    centerness_targets,
    enclosing_hbox,
    quad_area,
    sort_quadrilateral,
)
from dafne_torch.parallel.distributed import all_reduce_sum


def _max0(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def bce_with_logits(logits, targets):
    """Elementwise, numerically stable binary cross-entropy with logits."""
    return _max0(logits) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float, gamma: float):
    """Elementwise sigmoid focal loss (fvcore semantics, no reduction)."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


def smooth_l1(x, y, beta: float):
    """Elementwise smooth-L1 (fvcore semantics: exact L1 when beta < 1e-5)."""
    n = (x - y).abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def modulated_eight_point_loss(pred, target, beta: float, logspace: bool):
    """Per-box corner loss [..., 8] -> [...]: the minimum over the cyclic
    corner shifts {0, +1, +3} of the summed (optionally log1p'd)
    smooth-L1."""
    shape = pred.shape[:-1]
    p = pred.reshape(shape + (4, 2))

    def one(shifted):
        l = smooth_l1(shifted.reshape(shape + (8,)), target, beta)
        if logspace:
            l = torch.log1p(l)
        return l.sum(-1)

    l0 = one(p)
    l1 = one(p[..., [1, 2, 3, 0], :])
    l2 = one(p[..., [3, 0, 1, 2], :])
    return torch.minimum(l0, torch.minimum(l1, l2))


def plain_eight_point_loss(pred, target, beta: float, logspace: bool):
    l = smooth_l1(pred, target, beta)
    if logspace:
        l = torch.log1p(l)
    return l.sum(-1)


def rotated_iou_loss(pred, target, kind: str = "iou", eps: float = 1e-7):
    """1 - IoU ("iou") or 1 - GIoU with the enclosing axis-aligned box
    ("giou") of corner 8-vectors, through the clipped boundary integral,
    which is differentiable almost everywhere."""
    inter = quad_intersection_area_clip(pred, target)
    union = quad_area(pred) + quad_area(target) - inter
    iou = inter / torch.maximum(union, torch.full_like(union, eps))
    if kind == "iou":
        return 1.0 - iou
    hb_p = enclosing_hbox(pred)
    hb_t = enclosing_hbox(target)
    x0 = torch.minimum(hb_p[..., 0], hb_t[..., 0])
    y0 = torch.minimum(hb_p[..., 1], hb_t[..., 1])
    x1 = torch.maximum(hb_p[..., 2], hb_t[..., 2])
    y1 = torch.maximum(hb_p[..., 3], hb_t[..., 3])
    hull = _max0(x1 - x0) * _max0(y1 - y0)
    giou = iou - (hull - union) / torch.maximum(hull, torch.full_like(hull, eps))
    return 1.0 - giou


@dataclasses.dataclass(frozen=True)
class LossSpec:
    num_classes: int = 15
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 1.0 / 9.0
    loss_modulation: bool = True
    loss_logspace: bool = True
    loc_loss_type: str = "smoothl1"  # smoothl1 | iou | giou
    sort_corners: bool = True
    centerness: str = "oriented"  # none | plain | oriented
    centerness_alpha: float = 5.0
    has_center_reg: bool = True  # corner strategy == center-to-corner
    lambda_cls: float = 1.0
    lambda_corners: float = 1.0
    lambda_ctr: float = 1.0
    lambda_center: float = 1.0
    lambda_norm: bool = True

    @classmethod
    def from_config(cls, cfg) -> "LossSpec":
        d = cfg.MODEL.DAFNE
        return cls(
            num_classes=d.NUM_CLASSES,
            focal_alpha=d.LOSS_ALPHA,
            focal_gamma=d.LOSS_GAMMA,
            smooth_l1_beta=d.LOSS_SMOOTH_L1_BETA,
            loss_modulation=d.ENABLE_LOSS_MODULATION,
            loss_logspace=d.ENABLE_LOSS_LOG,
            loc_loss_type=d.LOC_LOSS_TYPE,
            sort_corners=d.SORT_CORNERS,
            centerness=d.CENTERNESS,
            centerness_alpha=d.CENTERNESS_ALPHA,
            has_center_reg=d.CORNER_PREDICTION == "center-to-corner",
            lambda_cls=d.LOSS_LAMBDA.CLS,
            lambda_corners=d.LOSS_LAMBDA.CORNERS,
            lambda_ctr=d.LOSS_LAMBDA.CTR,
            lambda_center=d.LOSS_LAMBDA.CENTER,
            lambda_norm=d.LOSS_LAMBDA_NORM,
        )

    def normalized_lambdas(self) -> Tuple[float, float, float, float]:
        """(cls, corners, ctr, center), normalized to sum 1 over the active
        terms when lambda_norm (dafne_outputs.py:192-206)."""
        lam_cls, lam_cor = self.lambda_cls, self.lambda_corners
        lam_ctr, lam_cen = self.lambda_ctr, self.lambda_center
        if self.lambda_norm:
            total = lam_cls + lam_cor
            if self.centerness != "none":
                total += lam_ctr
            if self.has_center_reg:
                total += lam_cen
            lam_cls, lam_cor = lam_cls / total, lam_cor / total
            lam_ctr, lam_cen = lam_ctr / total, lam_cen / total
        return lam_cls, lam_cor, lam_ctr, lam_cen


def dafne_losses(logits: torch.Tensor, corners_pred: torch.Tensor,
                 center_pred: Optional[torch.Tensor], ctrness_pred: torch.Tensor,
                 targets: Dict[str, torch.Tensor], spec: LossSpec) -> Dict[str, torch.Tensor]:
    """{loss/cls, loss/corners, loss/center, loss/ctr, loss/total, num_pos}
    from logits [N, K, C], corners_pred [N, K, 8] (stride-normalized),
    center_pred [N, K, 2] or None, ctrness_pred [N, K] and the targets of
    ``ops.targets.assign_targets``."""
    labels = targets["labels"].long()
    pos = (labels != spec.num_classes).to(torch.float32)
    num_pos = torch.clamp(all_reduce_sum(pos.sum()), min=1.0)

    # one_hot of the background label is all zeros, as jax.nn.one_hot's
    onehot = F.one_hot(labels, spec.num_classes + 1)[..., : spec.num_classes].to(logits.dtype)
    cls_loss = sigmoid_focal_loss(logits, onehot, spec.focal_alpha, spec.focal_gamma).sum() / num_pos

    if spec.centerness == "plain":
        ctr_t = centerness_targets(targets["reg_ltrb"], spec.centerness_alpha)
    else:  # oriented (and "none", which then overwrites with 1)
        ctr_t = centerness_targets(targets["reg_abcd"], spec.centerness_alpha)
    if spec.centerness == "none":
        ctr_t = torch.ones_like(ctr_t)
    ctr_t = ctr_t * pos
    loss_denorm = torch.clamp(all_reduce_sum(ctr_t.sum()), min=1e-6)

    cp = sort_quadrilateral(corners_pred) if spec.sort_corners else corners_pred
    if spec.loc_loss_type in ("iou", "giou"):
        per_box = rotated_iou_loss(cp, targets["reg_corners"], spec.loc_loss_type)
    elif spec.loss_modulation:
        per_box = modulated_eight_point_loss(cp, targets["reg_corners"], spec.smooth_l1_beta,
                                             spec.loss_logspace)
    else:
        per_box = plain_eight_point_loss(cp, targets["reg_corners"], spec.smooth_l1_beta,
                                         spec.loss_logspace)
    corners_loss = (per_box * ctr_t).sum() / loss_denorm

    losses = {}
    lam_cls, lam_cor, lam_ctr, lam_cen = spec.normalized_lambdas()
    losses["loss/cls"] = cls_loss * lam_cls
    losses["loss/corners"] = corners_loss * lam_cor

    if spec.has_center_reg and center_pred is not None:
        rc = targets["reg_corners"]
        center_t = rc.reshape(rc.shape[:-1] + (4, 2)).mean(-2)
        l = smooth_l1(center_pred, center_t, spec.smooth_l1_beta)
        if spec.loss_logspace:
            l = torch.log1p(l)
        losses["loss/center"] = (l.sum(-1) * ctr_t).sum() / loss_denorm * lam_cen

    if spec.centerness != "none":
        ctr_loss = (bce_with_logits(ctrness_pred, ctr_t) * pos).sum() / num_pos
        losses["loss/ctr"] = ctr_loss * lam_ctr

    losses["loss/total"] = sum(losses.values())
    losses["num_pos"] = num_pos
    return losses
