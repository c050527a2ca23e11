"""Top-k with ``jax.lax.top_k``'s tie rule: among equal values the lowest
index wins.  ``torch.topk`` promises no order among ties on CUDA, so both
functions take the first k of a stable descending sort.

Counterpart of ``dafne_tpu/ops/topk.py``; its radix select is a TPU
workaround and is not ported.
"""

from __future__ import annotations

import torch


def top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries over the last axis, in
    descending order, ties in ascending index order (``lax.top_k``)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def exact_topk_set(scores: torch.Tensor, k: int):
    """The set ``top_k`` selects, listed in ascending index order (the order
    the JAX function returns it in)."""
    n = scores.shape[-1]
    if k > n:
        raise ValueError(f"exact_topk_set: k={k} > n={n}")
    _, idx = top_k(scores, k)
    idx, _ = torch.sort(idx, dim=-1)
    return torch.gather(scores, -1, idx), idx
