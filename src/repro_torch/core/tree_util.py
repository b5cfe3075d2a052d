"""Row helpers shared by the round stages (``repro.core.tree_util``
counterpart).  The port runs the flat layout, where every per-client
quantity is one ``(M, P)`` matrix, so these act on tensors, not trees;
``tree_map`` walks the LM parameter and cache trees (dicts and lists)."""
from __future__ import annotations

import torch


def expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(M,) -> (M, 1, 1, ...) broadcastable against ``like`` (M, ...)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def tree_wsum(weights: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Σ_m weights[m] · rows[m], accumulated in float32 and returned in the
    rows' dtype, so float32 weights never promote the round state."""
    return torch.tensordot(weights, rows.float(), dims=1).to(rows.dtype)


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
