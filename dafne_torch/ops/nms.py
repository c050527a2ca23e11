"""Class-aware greedy rotated-quad NMS over fixed-size candidate sets.

Counterpart of ``dafne_tpu/ops/nms.py``: ``rotated_nms`` (global, one
problem per image) and ``rotated_nms_grouped`` (one problem per merged-class
group).  ``rotated_nms`` puts candidates in class-major order (ascending
merged class, score-descending within a class, invalid last), fills the
suppression matrix (``ops/kernels/quad_nms.py``) and takes the greedy
keep-set over it.  Greedy class-aware NMS decomposes over classes, so any
order that is score-descending within each class gives the same keep-set as
a global score order; the class-major one lets the kernel skip cross-class
blocks.

``impl`` selects the suppression matrix as the JAX argument does: "auto" and
"pallas" the strip kernel (K1), "pallas-2d" the 2-D tiled kernel (K2), each
writing S as bit rows for the greedy kernel, on CUDA tensors (on CPU
tensors the dispatchers take the plain versions, packed); "xla" the plain
int8 versions on any device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dafne_torch.ops.kernels.quad_nms import (
    TILE,
    greedy_keep_bits,
    greedy_keep_plain,
    suppression_bits,
    suppression_bits_2d,
    suppression_matrix_plain,
)
from dafne_torch.ops.topk import top_k

IMPLS = ("auto", "pallas", "pallas-2d", "xla")


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


def _greedy_over_suppression(pc, pk, pv, iou_threshold: float, impl: str):
    """Keep [B, P] from the padded kernel inputs (corners, classes, keep_init)
    through the suppression matrix and greedy walk that `impl` selects."""
    if impl not in IMPLS:
        raise ValueError(f"Unknown NMS impl {impl!r}: expected one of {IMPLS}")
    if impl == "xla":
        return greedy_keep_plain(suppression_matrix_plain(pc, pk, iou_threshold), pv)
    suppress = suppression_bits_2d if impl == "pallas-2d" else suppression_bits
    return greedy_keep_bits(suppress(pc, pk, iou_threshold), pv)


def rotated_nms(corners, scores, classes, valid, iou_threshold: float,
                class_merge: Sequence[Tuple[int, int]] = ((5, 4),),
                impl: str = "auto", scores01: bool = False) -> torch.Tensor:
    """Greedy class-aware rotated NMS over a batch.

    corners [B, N, 8], scores [B, N], classes [B, N] int, valid [B, N] bool.
    A box is suppressed when its exact quad IoU with an earlier kept box of
    the same merged class exceeds `iou_threshold`.  Returns keep [B, N]
    bool in input order."""
    n = corners.shape[1]
    order, pc, pk, pv = sorted_nms_inputs(corners, scores, classes, valid, class_merge, scores01)
    keep_sorted = _greedy_over_suppression(pc, pk, pv, iou_threshold, impl)[:, :n]
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def single_group_inputs(corners, valid):
    """The kernels' inputs for score-sorted candidates of one class group
    each: corners [R, K, 8], valid [R, K] (invalid last) -> (corners [R, P,
    8] CCW, classes [R, P] i32, 0 or -1, keep_init [R, P]) with P = K
    rounded up to a multiple of TILE.  One class and invalid last is
    class-major, so the strip kernel applies."""
    pad = (-corners.shape[1]) % TILE
    pc = torch.nn.functional.pad(_as_ccw_rows(corners).float(), (0, 0, 0, pad))
    pk = torch.nn.functional.pad(torch.where(valid, 0, -1).to(torch.int32), (0, pad), value=-1)
    pv = torch.nn.functional.pad(valid, (0, pad), value=False)
    return pc.contiguous(), pk.contiguous(), pv.contiguous()


def _nms_single_group(corners, valid, iou_threshold: float, impl: str):
    """Greedy NMS over score-sorted candidates of one class group each:
    corners [R, K, 8], valid [R, K] bool.  Returns keep [R, K] bool in the
    given order; all R problems share one launch of each kernel."""
    pc, pk, pv = single_group_inputs(corners, valid)
    return _greedy_over_suppression(pc, pk, pv, iou_threshold, impl)[:, : corners.shape[1]]


def group_budget(n: int, num_classes: int, class_merge: Sequence[Tuple[int, int]],
                 group_k: int, min_total: int):
    """(group class ids, K): the merged-class groups and each group's static
    candidate budget, K = min(n, max(group_k, ceil(min_total / G)))."""
    merged_away = {src for src, _ in class_merge}
    groups = [c for c in range(num_classes) if c not in merged_away]
    return groups, min(n, max(group_k, -(-min_total // max(len(groups), 1))))


def grouped_nms_inputs(corners, scores, classes, valid,
                       class_merge: Sequence[Tuple[int, int]] = ((5, 4),),
                       num_classes: int = 15, group_k: int = 512, min_total: int = 4096):
    """Each merged-class group's K top-scored candidates (``group_budget``)
    as one batch of [B * G, K] problems: (index [B, G * K] of each slot's
    candidate, corners [B * G, K, 8], valid [B * G, K])."""
    b, n = scores.shape
    groups, k = group_budget(n, num_classes, class_merge, group_k, min_total)
    g = len(groups)
    merged = apply_class_merge(classes, class_merge)
    group_ids = torch.tensor(groups, dtype=merged.dtype, device=merged.device)
    gmask = (merged[:, None, :] == group_ids[None, :, None]) & valid[:, None, :]  # [B, G, N]
    # -1 ranks padding below valid candidates of score 0; ties take the
    # lower index, as lax.top_k
    gscores = torch.where(gmask, scores[:, None, :], -1.0)
    _, top_idx = top_k(gscores, k)  # [B, G, K]
    gvalid = torch.gather(gmask, 2, top_idx)
    flat_idx = top_idx.reshape(b, g * k)
    gcorners = torch.gather(corners, 1, flat_idx[..., None].expand(-1, -1, 8))
    return flat_idx, gcorners.reshape(b * g, k, 8), gvalid.reshape(b * g, k)


def rotated_nms_grouped_batched(corners, scores, classes, valid, iou_threshold: float,
                                class_merge: Sequence[Tuple[int, int]] = ((5, 4),),
                                num_classes: int = 15, group_k: int = 512,
                                min_total: int = 4096, impl: str = "auto") -> torch.Tensor:
    """Class-aware greedy NMS decomposed into per-class-group problems.

    Cross-class pairs never suppress, so the global greedy over N candidates
    decomposes exactly into greedy passes over each merged-class group's
    candidates in score order.  Each group keeps its K top-scored candidates
    (``group_budget``); the keep-set equals ``rotated_nms``'s whenever no
    group has more than K valid candidates, and otherwise drops each
    group's lowest scored.  All B x G groups of the batch share one launch
    of the suppression kernel and one of the greedy kernel.

    corners [B, N, 8], scores [B, N] (0 for invalid), classes [B, N] int,
    valid [B, N] bool.  Returns keep [B, N] bool in input order."""
    b, n = scores.shape
    flat_idx, gcorners, gvalid = grouped_nms_inputs(corners, scores, classes, valid, class_merge,
                                                    num_classes, group_k, min_total)
    keep_g = _nms_single_group(gcorners, gvalid, iou_threshold, impl)
    # out-of-group padding repeats indices across slots: a max-reduce keeps
    # each candidate's own verdict deterministically
    keep = torch.zeros((b, n), dtype=torch.uint8, device=scores.device).scatter_reduce(
        1, flat_idx, keep_g.reshape(b, -1).to(torch.uint8), reduce="amax")
    return keep.bool() & valid


def rotated_nms_grouped(corners, scores, classes, valid, iou_threshold: float,
                        class_merge: Sequence[Tuple[int, int]] = ((5, 4),),
                        num_classes: int = 15, group_k: int = 512,
                        min_total: int = 4096, impl: str = "auto") -> torch.Tensor:
    """``rotated_nms_grouped_batched`` of one image: corners [N, 8], scores,
    classes, valid [N].  Returns keep [N] bool."""
    return rotated_nms_grouped_batched(
        corners[None], scores[None], classes[None], valid[None], iou_threshold,
        class_merge, num_classes, group_k, min_total, impl)[0]
