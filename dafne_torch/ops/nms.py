"""Class-aware greedy rotated-quad NMS over fixed-size candidate sets.

Counterpart of ``dafne_tpu/ops/nms.py::rotated_nms`` on its kernel path:
candidates are put in class-major order (ascending merged class,
score-descending within a class, invalid last), the suppression matrix is
filled (``ops/kernels/quad_nms.py``) and the greedy keep-set is taken over
it.  Greedy class-aware NMS decomposes over classes, so any order that is
score-descending within each class gives the same keep-set as a global
score order; the class-major one lets the kernel skip cross-class blocks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dafne_torch.ops.kernels.quad_nms import TILE, greedy_keep, suppression_matrix


def apply_class_merge(classes: torch.Tensor, class_merge: Sequence[Tuple[int, int]]):
    """Remap class ids for NMS grouping (e.g. DOTA large-vehicle(5)->small(4))."""
    merged = classes
    for src, dst in class_merge:
        merged = torch.where(merged == src, dst, merged)
    return merged


def _as_ccw_rows(corners: torch.Tensor) -> torch.Tensor:
    """[..., 8] -> counter-clockwise vertex order."""
    v = corners.reshape(corners.shape[:-1] + (4, 2))
    nxt = torch.roll(v, shifts=-1, dims=-2)
    s = 0.5 * torch.sum(v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1], -1)
    return torch.where(s[..., None, None] < 0.0, v.flip(-2), v).reshape(corners.shape)


def class_major_order(scores, merged, valid, scores01: bool):
    """[B, N] permutation into class-major, score-descending-within-class
    order with invalid slots last; ties keep the lower input index.

    With `scores01` (scores in [0, 1]) one f32 key class*2 + (1 - score) is
    sorted, formed in the JAX function's dtype and op order so that
    near-ties order alike; otherwise two stable sorts compose the order."""
    inf = torch.tensor(float("inf"), dtype=scores.dtype, device=scores.device)
    if scores01:
        key = merged.to(scores.dtype) * 2.0 + (1.0 - torch.clamp(scores, 0.0, 1.0))
        return torch.argsort(torch.where(valid, key, inf), dim=-1, stable=True)
    order1 = torch.argsort(torch.where(valid, -scores, inf), dim=-1, stable=True)
    cls1 = torch.where(
        torch.gather(valid, 1, order1), torch.gather(merged, 1, order1).to(torch.int32), 2**30
    )
    return torch.gather(order1, 1, torch.argsort(cls1, dim=-1, stable=True))


def sorted_nms_inputs(corners, scores, classes, valid,
                      class_merge: Sequence[Tuple[int, int]] = ((5, 4),),
                      scores01: bool = False):
    """The kernels' inputs: (order [B, N], corners [B, P, 8] CCW, classes
    [B, P] i32 with -1 for invalid and padded slots, keep_init [B, P]) with
    P = N rounded up to a multiple of TILE."""
    merged = apply_class_merge(classes, class_merge)
    order = class_major_order(scores, merged, valid, scores01)
    s_corners = torch.gather(corners, 1, order[..., None].expand(-1, -1, 8))
    s_valid = torch.gather(valid, 1, order)
    s_classes = torch.where(s_valid, torch.gather(merged, 1, order), -1).to(torch.int32)
    pad = (-corners.shape[1]) % TILE
    pc = torch.nn.functional.pad(_as_ccw_rows(s_corners).float(), (0, 0, 0, pad))
    pk = torch.nn.functional.pad(s_classes, (0, pad), value=-1)
    pv = torch.nn.functional.pad(s_valid, (0, pad), value=False)
    return order, pc.contiguous(), pk.contiguous(), pv.contiguous()


def rotated_nms(corners, scores, classes, valid, iou_threshold: float,
                class_merge: Sequence[Tuple[int, int]] = ((5, 4),),
                scores01: bool = False) -> torch.Tensor:
    """Greedy class-aware rotated NMS over a batch.

    corners [B, N, 8], scores [B, N], classes [B, N] int, valid [B, N] bool.
    A box is suppressed when its exact quad IoU with an earlier kept box of
    the same merged class exceeds `iou_threshold`.  Returns keep [B, N]
    bool in input order."""
    n = corners.shape[1]
    order, pc, pk, pv = sorted_nms_inputs(corners, scores, classes, valid, class_merge, scores01)
    s = suppression_matrix(pc, pk, iou_threshold)
    keep_sorted = greedy_keep(s, pv)[:, :n]
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)
