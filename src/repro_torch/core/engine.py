"""Chunked execution (``repro.core.engine`` counterpart): R rounds per host
sync, for full participation (``make_round_chunk``) and for cohort rounds
(``make_population_chunk``).  The reference fuses the chunk into one jitted
``lax.scan``; PyTorch runs eagerly, so the chunk is a Python loop over the
unmodified round that never reads a device value, and the host waits for
the device only where the caller reads the metrics.  (Capturing the chunk
in a CUDA graph is a later step.)

Device mode, the counterpart of the reference's in-scan sampling: given a
device batcher's ``sample_fn`` the chunk takes the round indices instead
of stacked batches and gathers all its rounds' batches from the
device-resident dataset in one keyed draw (``DeviceBatcher.sample_chunk``),
so no batch tensor crosses from the host.  A cohort chunk's ``cohort_fn``
and ``scenario_fn`` are keyed O(C) draws that run on the host, as the
reference's host mirrors do; the chunk ships their ``(r, C)`` id, K and
weight tables to the device once."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.stages import delivered_weights, last_occurrence
from repro_torch.core.tree_util import tree_leaves


def _run(state: dict, r: int, donate: bool, step: Callable
         ) -> tuple[dict, dict]:
    """``state, metrics = step(j, state)`` for j < r, the metrics stacked
    per round.  ``donate=True`` empties the given dict, so the state from
    before the chunk is freed once round 1 has replaced it, and refills it
    with the last finished round's state if a round raises."""
    given = state
    if donate:
        state = dict(given)
        given.clear()
    per_round = []
    try:
        for j in range(r):
            state, metrics = step(j, state)
            per_round.append(metrics)
    except BaseException:
        if donate:
            given.update(state)
        raise
    return state, {key: torch.stack([mt[key] for mt in per_round])
                   for key in per_round[0]}


def make_round_chunk(round_fn: Callable, r: Optional[int],
                     donate: bool = False,
                     sample_fn: Optional[Callable] = None) -> Callable:
    """``chunk_fn(state, batches, k_steps, weights, lam) -> (state,
    metrics)`` running ``r`` rounds.  ``r=None`` builds a
    length-polymorphic chunk: it runs as many rounds as ``k_steps`` has
    rows (the launch trainer's shorter tail chunk); a fixed ``r`` refuses
    any other count.

    Inputs are stacked per round: ``batches`` holds ``(r, M, k_max, …)``
    tensors, ``k_steps`` is ``(r, M)``, ``weights`` ``(r, M)`` and ``lam``
    a sequence of ``r`` host floats; ``noise`` (optional, ``(r, 2, M, P)``)
    holds a payload attack's noise rows, drawn on the host before the
    chunk, and round j gets ``noise=noise[j]``.  Each metric comes back as
    an ``(r,)`` device tensor.  A chunk of r rounds is the same computation
    as r ``round_fn`` calls.  With ``sample_fn`` (a device batcher's
    ``ts -> (r, M, k_max, …)`` draw) ``batches`` is instead the ``(r,)``
    round indices, and the chunk draws its batches on the device.

    ``donate=True`` is the counterpart of the reference's donated carry:
    the chunk empties the ``state`` dict it is given, so the state from
    before the chunk is freed once round 1 has replaced it, as when rounds
    run one by one (at an LM's size one state is several ``(M, P)``
    matrices).  If a round raises, the dict is refilled with the state
    after the last round that finished.  With ``donate=False`` the chunk
    leaves its argument alone."""
    def chunk_fn(state: dict, batches, k_steps: torch.Tensor,
                 weights: torch.Tensor, lam: Sequence[float],
                 noise: Optional[torch.Tensor] = None):
        n = k_steps.shape[0]
        if r is not None and n != r:
            raise ValueError(f"chunk built for {r} rounds, got {n}")
        if sample_fn is not None:
            batches = sample_fn(batches)

        def step(j, st):
            kw = {} if noise is None else {"noise": noise[j]}
            return round_fn(st, {key: v[j] for key, v in batches.items()},
                            k_steps[j], weights[j], lam[j], **kw)

        return _run(state, n, donate, step)

    return chunk_fn


def stacked_lasts(cohorts: np.ndarray, device: torch.device
                  ) -> Optional[torch.Tensor]:
    """Each cohort's ``stages.last_occurrence`` on ``device``, ``(r, C)``
    int64, or None where no cohort repeats an id."""
    lasts = np.stack([last_occurrence(ids) for ids in cohorts])
    if np.array_equal(lasts, np.broadcast_to(
            np.arange(cohorts.shape[1]), lasts.shape)):
        return None
    return torch.from_numpy(lasts).to(device)


def make_population_chunk(round_fn: Callable, r: int,
                          donate: bool = False, *,
                          cohort_fn: Optional[Callable] = None,
                          sample_fn: Optional[Callable] = None,
                          scenario_fn: Optional[Callable] = None
                          ) -> Callable:
    """``r`` cohort rounds (``flat.make_flat_cohort_round`` or the tree
    layout's ``stages.make_cohort_round``) per call, in
    two modes, as the reference's:

    * **host** (neither ``cohort_fn`` nor ``sample_fn``): ``chunk_fn(state,
      batches, cohorts, k_steps, cweights, lam, lasts=None, noise=None)``
      with every input stacked per round: ``batches`` ``(r, C, k_max, …)``
      tensors, ``cohorts`` ``(r, C)`` int64, ``k_steps`` ``(r, C)``,
      ``cweights`` ``(r, C)``, ``lam`` a sequence of ``r`` host floats,
      ``lasts`` None (no id repeats within a cohort) or each cohort's
      ``stages.last_occurrence``, ``(r, C)`` int64, and ``noise`` None or
      a payload attack's ``(r, 2, C, P)`` noise rows.  Under a failure
      scenario the caller has already put each round's k′ rows in
      ``k_steps`` and its delivered weights in ``cweights``.
    * **device** (``cohort_fn`` + ``sample_fn``): ``chunk_fn(state, ts,
      k_rows, lam, noise_fn=None)`` with ``ts`` the ``r`` round indices
      and ``k_rows`` the ``(r, M)`` host K-schedule rows.
      ``cohort_fn(t) -> (ids, w̃)`` (``ClientPopulation.cohort_and_weights``)
      draws each cohort on the host; ``scenario_fn(t, k_c, ids) -> k′``
      (a scenario's keyed ``k_eff``) maps the cohort's scheduled K to the
      steps it completes, and the weights are scaled by the delivered
      fraction (``stages.delivered_weights``), as in the reference's
      scan; the ``(r, C)`` tables go to the state's device in one copy
      each, and ``sample_fn(ts, cohorts) -> (r, C, k_max, …)``
      (``DeviceBatcher.sample_chunk``) draws every round's batches there.
      ``noise_fn(cohorts)`` gives a payload attack's ``(r, 2, C, P)``
      noise rows for the drawn cohorts, or None.

    Each metric comes back as an ``(r,)`` device tensor, and a chunk of r
    rounds is the same computation as r ``round_fn`` calls on the same
    inputs.  ``donate=True`` hands the state over as ``make_round_chunk``'s
    does, and each round then updates the population-sized ν⁽ⁱ⁾,
    error-feedback and health stores in place."""
    if (cohort_fn is None) != (sample_fn is None):
        raise ValueError("cohort_fn and sample_fn come as a pair: in-scan "
                         "cohorts need an in-scan (device) batch sampler")
    if scenario_fn is not None and cohort_fn is None:
        raise ValueError("scenario_fn is an in-scan (device-mode) hook; "
                         "host-precomputed chunks perturb their stacked "
                         "inputs before the dispatch")

    def host_chunk(state: dict, batches: dict, cohorts: torch.Tensor,
                   k_steps: torch.Tensor, cweights: torch.Tensor,
                   lam: Sequence[float], lasts: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        if cohorts.shape[0] != r:
            raise ValueError(f"chunk built for {r} rounds, got "
                             f"{cohorts.shape[0]}")

        def step(j, st):
            return round_fn(
                st, {key: v[j] for key, v in batches.items()}, cohorts[j],
                k_steps[j], cweights[j], lam[j], donate=donate,
                last=None if lasts is None else lasts[j],
                noise=None if noise is None else noise[j])

        return _run(state, r, donate, step)

    if cohort_fn is None:
        return host_chunk

    def device_chunk(state: dict, ts: Sequence[int], k_rows: np.ndarray,
                     lam: Sequence[float],
                     noise_fn: Optional[Callable] = None):
        if len(ts) != r:
            raise ValueError(f"chunk built for {r} rounds, got {len(ts)}")
        ids, ks, cws = [], [], []
        for j, t in enumerate(ts):
            ids_t, cw = cohort_fn(int(t))
            k_c = np.asarray(k_rows[j])[ids_t]
            if scenario_fn is not None:
                k_eff = scenario_fn(int(t), k_c, ids_t)
                cw = delivered_weights(cw, k_eff, k_c)
                k_c = k_eff
            ids.append(ids_t)
            ks.append(k_c)
            cws.append(cw)
        cohorts = np.stack(ids).astype(np.int64)
        device = tree_leaves(state["params"])[0].device
        dev_ids = torch.from_numpy(cohorts).to(device)
        batches = sample_fn(torch.as_tensor(np.asarray(ts, np.int64)).to(
            device), dev_ids)
        return host_chunk(
            state, batches, dev_ids,
            torch.from_numpy(np.stack(ks).astype(np.int32)).to(device),
            torch.from_numpy(np.stack(cws).astype(np.float32)).to(device),
            lam, stacked_lasts(cohorts, device),
            None if noise_fn is None else noise_fn(cohorts))

    return device_chunk
