"""Round stages after the local steps (``repro.core.stages`` counterpart):
aggregation, orientation (what each client transmits toward the next ν) and
the server optimizer, on the flat layout's ``(P,)`` / ``(M, P)`` tensors.

``Algorithm`` (core/fedopt.py) names a composition: ``algo.aggregator``,
``algo.selector`` and ``algo.server_opt`` index these registries.  Every
stage does the reference's float32 arithmetic in the reference's order and
returns tensors in the state's dtype; λ arrives as a host float.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.fedopt import Algorithm
from repro_torch.core.tree_util import expand, tree_wsum


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def aggregate_mean(params0: torch.Tensor, x_i: torch.Tensor,
                   kf: torch.Tensor, weights: torch.Tensor,
                   kbar: torch.Tensor) -> torch.Tensor:
    """Plain weighted average  Σ ω_i x⁽ⁱ⁾."""
    return tree_wsum(weights, x_i)


def aggregate_fednova(params0: torch.Tensor, x_i: torch.Tensor,
                      kf: torch.Tensor, weights: torch.Tensor,
                      kbar: torch.Tensor) -> torch.Tensor:
    """FedNova:  x̃ + K̄ Σ ω_i (x⁽ⁱ⁾ − x̃)/K_i  (Wang et al. 2020)."""
    deltas = (x_i.float() - params0[None]) / expand(kf, x_i)
    return (params0 + kbar * torch.tensordot(weights, deltas, dims=1)
            ).to(params0.dtype)


AGGREGATORS: dict[str, Callable] = {
    "mean": aggregate_mean,
    "fednova": aggregate_fednova,
}


def buffered_mean(params: torch.Tensor, anchor_i: torch.Tensor,
                  x_i: torch.Tensor, kf: torch.Tensor,
                  sweights: torch.Tensor, kbar: torch.Tensor
                  ) -> torch.Tensor:
    """Pseudo-delta average  x + Σ_i w̃_i (x⁽ⁱ⁾ − anchorᵢ)  over ``(C, P)``
    rows (``anchor_i`` ``(C, P)`` or ``(1, P)``).  The weights are not
    renormalized: with Σ w̃ = 1 this is the synchronous weighted
    average."""
    deltas = x_i.float() - anchor_i.float()
    return (params.float() + torch.tensordot(sweights, deltas, dims=1)
            ).to(params.dtype)


def buffered_fednova(params: torch.Tensor, anchor_i: torch.Tensor,
                     x_i: torch.Tensor, kf: torch.Tensor,
                     sweights: torch.Tensor, kbar: torch.Tensor
                     ) -> torch.Tensor:
    """Pseudo-delta FedNova:  x + K̄ Σ_i w̃_i (x⁽ⁱ⁾ − anchorᵢ)/K_i."""
    deltas = (x_i.float() - anchor_i.float()) / expand(kf, x_i)
    return (params.float() + kbar * torch.tensordot(sweights, deltas,
                                                    dims=1)
            ).to(params.dtype)


BUFFERED_AGGREGATORS: dict[str, Callable] = {
    "mean": buffered_mean,
    "fednova": buffered_fednova,
}


def delivered_weights(weights, k_eff, k_sched) -> np.ndarray:
    """Partial-work recovery weight rule (fed/scenarios.py): a mid-round
    dropout delivering k′ < K completed steps keeps its (FedNova-normalized)
    per-step direction but carries only the mass it earned, w̃ ← w̃ · k′/K
    — NOT renormalized, so lost work is lost mass.  float32 numpy: the
    host tables of a chunk (the reference's host mirror)."""
    frac = (np.asarray(k_eff).astype(np.float32)
            / np.maximum(np.asarray(k_sched).astype(np.float32),
                         np.float32(1.0)))
    return np.asarray(weights, np.float32) * frac


def nu_mass_mix(nu: torch.Tensor, contrib: torch.Tensor,
                mass: torch.Tensor) -> torch.Tensor:
    """ν ← (1 − ρ) ν + (ρ/Σw̃)·Σ w̃ transmitᵢ with ρ = min(Σw̃, 1): keep ρ of
    the new signal, renormalized, so the mix stays convex when duplicate
    ids or Horvitz–Thompson weights push Σw̃ past 1; at Σw̃ = 1 it is the
    synchronous ν."""
    rho = torch.clamp(mass, max=1.0)
    return ((1.0 - rho) * nu.float() + (rho / mass) * contrib.float()
            ).to(nu.dtype)


def last_occurrence(ids) -> "np.ndarray":
    """(B,) int64: for each position j of the host id array ``ids``, the
    position of the LAST occurrence of ``ids[j]`` — the occurrence the
    reference's scatter keeps when an id repeats (a fast client reporting
    twice into one buffer, a weighted cohort drawing a client twice).
    Rows taken at these positions carry, for a repeated id, the same row
    at every occurrence, so a device scatter of them writes one value
    whatever order its writes land in."""
    ids = np.asarray(ids)
    last = np.arange(len(ids), dtype=np.int64)
    seen: dict = {}
    for j in range(len(ids) - 1, -1, -1):
        last[j] = seen.setdefault(int(ids[j]), j)
    return last


def scatter_nu_rows(nu_i: torch.Tensor, new_nu: torch.Tensor,
                    avg_g: torch.Tensor, ids: torch.Tensor,
                    nu_decay: float = 0.0, *, in_place: bool = False,
                    last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the participants' fresh ν̄⁽ⁱ⁾ rows into the population-sized
    ``(M, P)`` store; the other rows first decay toward the new ν at
    ``nu_decay`` per round (their correction ν − ν⁽ⁱ⁾ → 0; 0 keeps them
    frozen).  ``ids`` is an int64 index tensor; where an id repeats,
    ``last`` (``last_occurrence`` of the host ids, on the device) makes
    every occurrence carry the last one's row, the one the reference
    keeps, so the write is the same whatever order the device makes it
    in.

    ``in_place=True`` updates ``nu_i`` itself (``lerp_`` only when
    ``nu_decay > 0``, then ``index_copy_`` of the C rows) and returns it:
    for a caller that owns the state, whose store would otherwise be
    copied whole every round."""
    rows = (avg_g if last is None else avg_g.index_select(0, last)
            ).to(nu_i.dtype)
    if in_place:
        if nu_decay:
            nu_i.lerp_(new_nu.to(nu_i.dtype), nu_decay)
        return nu_i.index_copy_(0, ids, rows)
    out = (torch.lerp(nu_i, new_nu.to(nu_i.dtype), nu_decay) if nu_decay
           else nu_i.clone())
    return out.index_copy_(0, ids, rows)


# ---------------------------------------------------------------------------
# orientation (transmit selection)
# ---------------------------------------------------------------------------

def _select_avg(g0_i, avg_g, fast):
    return avg_g


def _select_first(g0_i, avg_g, fast):
    return g0_i


def _select_fedagrac(g0_i, avg_g, fast):
    """Fast clients (K_i > K̄) send the first stochastic gradient, slow
    clients the averaged gradient (paper §4.2)."""
    return torch.where(expand(fast, avg_g), g0_i, avg_g)


def _select_reverse(g0_i, avg_g, fast):
    return torch.where(expand(fast, avg_g), avg_g, g0_i)


SELECTORS: dict[str, Callable] = {
    "avg": _select_avg,
    "first": _select_first,
    "fedagrac": _select_fedagrac,
    "reverse": _select_reverse,
}


def fast_mask(kf: torch.Tensor, kbar: torch.Tensor) -> torch.Tensor:
    """K_i > K̄ with a tie tolerance: K_i are integers but K̄ is a float32
    dot whose summation order can leave it 1 ulp under an exact tie."""
    return kf > kbar + 1e-4 * torch.clamp(kbar, min=1.0)


def recover_avg_grad(params0: torch.Tensor, x_i: torch.Tensor,
                     c_all: torch.Tensor, kf: torch.Tensor, lr: float,
                     lam: float, anchor_i: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Delta recovery of the averaged local gradient (paper §4.2):
    ν̄⁽ⁱ⁾ = (x̃ − x⁽ⁱ⁾_{K_i}) / (η K_i) − λ c⁽ⁱ⁾.  ``anchor_i`` (``(B, P)``
    rows, each client's dispatch-time model) replaces the shared x̃ on the
    buffered-async path."""
    x0 = params0[None] if anchor_i is None else anchor_i
    return ((x0.float() - x_i.float()) / (lr * expand(kf, x_i))
            - lam * c_all.float()).to(x0.dtype)


def orientation_transmit(algo: Algorithm, params0: torch.Tensor,
                         x_i: torch.Tensor, g0_i: torch.Tensor,
                         c_all: torch.Tensor, kf: torch.Tensor,
                         kbar: torch.Tensor, lr: float, lam: float,
                         anchor_i: Optional[torch.Tensor] = None):
    """Per-client (transmit, avg_g): what flows into the next global ν, and
    the local reference ν⁽ⁱ⁾ (Alg. 1 line 11 — always the averaged grad).
    ``anchor_i`` as in ``recover_avg_grad``."""
    avg_g = recover_avg_grad(params0, x_i, c_all, kf, lr, lam, anchor_i)
    transmit = SELECTORS[algo.selector](g0_i, avg_g, fast_mask(kf, kbar))
    return transmit, avg_g


# ---------------------------------------------------------------------------
# server optimizer (FedOpt, Reddi et al. 2021)
# ---------------------------------------------------------------------------

def _server_sgd(algo, state, params0, agg, delta, new_state):
    """server_opt="sgd", server_lr=1 reproduces plain averaging exactly."""
    lr = algo.server_lr
    if lr == 1.0:
        return agg
    return (params0.float() + lr * delta).to(params0.dtype)


def _server_momentum(algo, state, params0, agg, delta, new_state):
    """FedAvgM."""
    lr, b1 = algo.server_lr, algo.server_beta1
    m = b1 * state["server_m"].float() + delta
    new_state["server_m"] = m.to(params0.dtype)
    return (params0.float() + lr * m).to(params0.dtype)


def _server_adam(algo, state, params0, agg, delta, new_state):
    """FedAdam."""
    lr, b1 = algo.server_lr, algo.server_beta1
    b2, eps = 0.999, 1e-8
    t = state["round"].float() + 1.0
    m = b1 * state["server_m"].float() + (1 - b1) * delta
    v = b2 * state["server_v"].float() + (1 - b2) * delta * delta
    new_state["server_m"] = m.to(params0.dtype)
    new_state["server_v"] = v.to(params0.dtype)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    return (params0.float() + lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            ).to(params0.dtype)


SERVER_OPTIMIZERS: dict[str, Callable] = {
    "sgd": _server_sgd,
    "momentum": _server_momentum,
    "adam": _server_adam,
}


def server_update(algo: Algorithm, state: dict, params0: torch.Tensor,
                  agg: torch.Tensor, new_state: dict) -> torch.Tensor:
    """FedOpt server step on the round pseudo-gradient Δ = agg − x̃_t."""
    if algo.server_opt not in SERVER_OPTIMIZERS:
        raise ValueError(algo.server_opt)
    delta = agg.float() - params0.float()
    return SERVER_OPTIMIZERS[algo.server_opt](algo, state, params0, agg,
                                              delta, new_state)
