"""Functional SGD with momentum and weight decay (``repro.optim.sgd``
counterpart): plain functions on tensor trees (dicts, lists and tuples of
tensors), each update a new tree, nothing written in place.  The scalars
(lr, momentum, weight decay) are rounded to each leaf's dtype before they
multiply it, as the reference's weakly typed Python floats are: 0.9
scales a bfloat16 leaf as 0.8984375 in both packages."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree_util import tree_map

PyTree = Any


class SGDState(NamedTuple):
    momentum: PyTree


def _times(c: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(c, dtype=x.dtype, device=x.device) * x


def sgd_init(params: PyTree, momentum: float = 0.0) -> SGDState:
    """No state without momentum; a zero tree like ``params`` with it."""
    if momentum == 0.0:
        return SGDState(momentum=None)
    return SGDState(momentum=tree_map(torch.zeros_like, params))


def sgd_update(grads: PyTree, state: SGDState, params: PyTree, *,
               lr: float, momentum: float = 0.0,
               weight_decay: float = 0.0) -> tuple[PyTree, SGDState]:
    """(updates, state): ``−lr · (g + wd · p)``, or with momentum
    ``−lr · m`` for ``m ← momentum · m + g + wd · p``."""
    if weight_decay:
        grads = tree_map(lambda g, p: g + _times(weight_decay, p), grads,
                         params)
    if momentum and state.momentum is not None:
        new_m = tree_map(lambda m, g: _times(momentum, m) + g,
                         state.momentum, grads)
        return (tree_map(lambda m: _times(-lr, m), new_m),
                SGDState(momentum=new_m))
    return tree_map(lambda g: _times(-lr, g), grads), state


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``p + u`` in each leaf's own dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
