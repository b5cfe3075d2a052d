"""Functional AdamW (``repro.optim.adamw`` counterpart): the moments are
float32 whatever the parameters' dtype, the step an int32 scalar on the
parameters' device, and each update is cast to its parameter's dtype."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree_util import tree_leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


def adamw_init(params: PyTree) -> AdamWState:
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros())


def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8,
                 weight_decay: float = 0.0) -> tuple[PyTree, AdamWState]:
    """(updates, state): ``−lr · (m̂ / (√v̂ + eps) + wd · p)`` with the
    bias-corrected float32 moments of the step's gradients."""
    step = state.step + 1
    gf = tree_map(lambda g: g.float(), grads)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, gf)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, gf)
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)

    def upd(m, v, p):
        u = -lr * (m / bc1 / (torch.sqrt(v / bc2) + eps)
                   + weight_decay * p.float())
        return u.to(p.dtype)

    return tree_map(upd, mu, nu, params), AdamWState(step=step, mu=mu, nu=nu)
