"""Tree helpers shared by the round stages (``repro.core.tree_util``
counterpart).  A tree is nested dicts, lists and tuples of tensors (a paper
model's dict, an LM's ``{"segments": [...], …}``); a bare tensor is a tree
of one leaf, so every helper serves the flat layout's ``(P,)`` / ``(M, P)``
buffers and the tree layout's leaves alike, and a flat caller gets the
tensor it passed in."""
from __future__ import annotations

from typing import Any

import torch

PyTree = Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples), with the
    matching leaves of the trees ``rest`` (same containers) as further
    arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_zeros(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_stack_zeros(tree: PyTree, m: int) -> PyTree:
    """Zero tree with a new leading client axis of size ``m``."""
    return tree_map(lambda a: a.new_zeros((m,) + tuple(a.shape)), tree)


def expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(M,) -> (M, 1, 1, ...) broadcastable against ``like`` (M, ...)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def rows_dot(weights: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Σ_m weights[m] · a[m] over the leading (client) dim."""
    return torch.tensordot(weights, a, dims=1)


def tree_wsum(weights: torch.Tensor, tree: PyTree, dot=rows_dot) -> PyTree:
    """Σ_m weights[m] · tree[m] per leaf, accumulated in float32 and returned
    in the leaf's dtype, so float32 weights never promote the round
    state.  ``dot`` is the client-dim sum (a mesh's ``param_constraint``
    gives its own)."""
    return tree_map(lambda a: dot(weights, a.float()).to(a.dtype), tree)
