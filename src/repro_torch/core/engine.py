"""Chunked execution (``repro.core.engine`` counterpart): R rounds per host
sync, for full participation (``make_round_chunk``) and for cohort rounds
(``make_population_chunk``).  The reference fuses the chunk into one jitted ``lax.scan``; PyTorch
runs eagerly, so the chunk is a Python loop over the unmodified round that
never reads a device value, and the host waits for the device only where
the caller reads the metrics.  (Capturing the chunk in a CUDA graph is a
later step.)"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def make_round_chunk(round_fn: Callable, r: int,
                     donate: bool = False) -> Callable:
    """``chunk_fn(state, batches, k_steps, weights, lam) -> (state,
    metrics)`` running ``r`` rounds.

    Inputs are stacked per round: ``batches`` holds ``(r, M, k_max, …)``
    tensors, ``k_steps`` is ``(r, M)``, ``weights`` ``(r, M)`` and ``lam``
    a sequence of ``r`` host floats; ``noise`` (optional, ``(r, 2, M, P)``)
    holds a payload attack's noise rows, drawn on the host before the
    chunk, and round j gets ``noise=noise[j]``.  Each metric comes back as
    an ``(r,)`` device tensor.  A chunk of r rounds is the same computation
    as r ``round_fn`` calls.

    ``donate=True`` is the counterpart of the reference's donated carry:
    the chunk empties the ``state`` dict it is given, so the state from
    before the chunk is freed once round 1 has replaced it, as when rounds
    run one by one (at an LM's size one state is several ``(M, P)``
    matrices).  If a round raises, the dict is refilled with the state
    after the last round that finished.  With ``donate=False`` the chunk
    leaves its argument alone."""
    def chunk_fn(state: dict, batches: dict, k_steps: torch.Tensor,
                 weights: torch.Tensor, lam: Sequence[float],
                 noise: Optional[torch.Tensor] = None):
        if k_steps.shape[0] != r:
            raise ValueError(f"chunk built for {r} rounds, got "
                             f"{k_steps.shape[0]}")
        given = state
        if donate:
            state = dict(given)
            given.clear()
        per_round = []
        try:
            for j in range(r):
                kw = {} if noise is None else {"noise": noise[j]}
                state, metrics = round_fn(
                    state, {key: v[j] for key, v in batches.items()},
                    k_steps[j], weights[j], lam[j], **kw)
                per_round.append(metrics)
        except BaseException:
            if donate:
                given.update(state)
            raise
        return state, {key: torch.stack([mt[key] for mt in per_round])
                       for key in per_round[0]}

    return chunk_fn


def make_population_chunk(round_fn: Callable, r: int,
                          donate: bool = False,
                          scenario_fn: Optional[Callable] = None
                          ) -> Callable:
    """``chunk_fn(state, batches, cohorts, k_steps, cweights, lam,
    lasts=None) -> (state, metrics)`` running ``r`` cohort rounds
    (``flat.make_flat_cohort_round``) on cohorts drawn on the host.

    Every input is stacked per round: ``batches`` holds ``(r, C, k_max,
    …)`` tensors, ``cohorts`` is ``(r, C)`` int64, ``k_steps`` ``(r, C)``,
    ``cweights`` ``(r, C)``, ``lam`` a sequence of ``r`` host floats and
    ``lasts`` None (no id repeats within a cohort) or each cohort's
    ``stages.last_occurrence``, ``(r, C)`` int64, and ``noise`` None or a
    payload attack's ``(r, 2, C, P)`` noise rows; each metric comes back as
    an ``(r,)`` device tensor.  Under a failure scenario the host has
    already put each round's k′ rows in ``k_steps`` and its delivered
    weights in ``cweights``, so the chunk reads nothing more.  A chunk of r rounds is the same computation
    as r ``round_fn`` calls.

    ``donate=True`` hands the state over as ``make_round_chunk``'s does
    (the given dict is emptied, and refilled with the last finished
    round's state if a round raises), and each round then updates the
    population-sized ν⁽ⁱ⁾, error-feedback and health stores in place.
    (The reference's device mode, cohorts and batches drawn inside the
    chunk with its in-scan ``scenario_fn``, needs a device batcher:
    ROADMAP A5/A6.)  A ``scenario_fn`` — the reference's in-scan k′
    hook of that device mode — raises ``NotImplementedError``."""
    if scenario_fn is not None:
        raise NotImplementedError(
            "the PyTorch port does not run the in-scan scenario hook "
            "(scenario_fn, the device sampler's chunk: ROADMAP A5/A6) yet; "
            "host chunks take their k′ rows and delivered weights in "
            "k_steps and cweights")
    def chunk_fn(state: dict, batches: dict, cohorts: torch.Tensor,
                 k_steps: torch.Tensor, cweights: torch.Tensor,
                 lam: Sequence[float], lasts: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None):
        if cohorts.shape[0] != r:
            raise ValueError(f"chunk built for {r} rounds, got "
                             f"{cohorts.shape[0]}")
        given = state
        if donate:
            state = dict(given)
            given.clear()
        per_round = []
        try:
            for j in range(r):
                state, metrics = round_fn(
                    state, {key: v[j] for key, v in batches.items()},
                    cohorts[j], k_steps[j], cweights[j], lam[j],
                    donate=donate, last=None if lasts is None else lasts[j],
                    noise=None if noise is None else noise[j])
                per_round.append(metrics)
        except BaseException:
            if donate:
                given.update(state)
            raise
        return state, {key: torch.stack([mt[key] for mt in per_round])
                       for key in per_round[0]}

    return chunk_fn
