"""Buffered semi-asynchronous federated execution
(``repro.fed.async_engine`` counterpart).

The synchronous engine (fed/simulation.py) advances in lock-step rounds —
the straggler defines the round clock.  This engine drops the barrier:
clients train continuously, each report arrives after its simulated duration
(fed/clock.py), and the server updates once a **buffer** of M' ≤ M reports
has accumulated (Nguyen et al., FedBuff).  Arrived updates may be **stale**
— computed against a model version τ updates old — and are discounted by a
staleness weight s(τ) (Xie et al., FedAsync):

    constant : s(τ) = 1
    hinge    : s(τ) = 1                 τ ≤ b,   else 1 / (1 + a (τ − b))
    poly     : s(τ) = (1 + τ)^(−a)

The buffered server update on arrivals B with global weights ω and
discounts s_i = s(τ_i), w̃_i = ω_i s_i:

    x       ← serveropt( x,  Σ_{i∈B} w̃_i (x⁽ⁱ⁾ − x_{v_i}) )       (pseudo-deltas)
    ν       ← (1 − Σ_{i∈B} w̃_i) ν  +  Σ_{i∈B} w̃_i transmitᵢ      (mass-mixed)
    ν⁽ⁱ⁾    ← ν̄⁽ⁱ⁾   for i ∈ B only                              (row scatter)

All three reuse the synchronous stages (core/stages.py): the local steps
run from *per-client anchors* (the model version each client was dispatched
with), aggregation uses the pseudo-delta variants, and orientation recovers
ν̄⁽ⁱ⁾ against the same anchor.  With buffer = M, identical client speeds and
zero staleness every quantity reduces to the synchronous round.

The event order depends only on ``(k_schedule, clock, buffer_size)``, so
``run`` first simulates the whole timeline on the host
(``fed/clock.py::simulate_timeline``) and every decision is made there:
each chunk's tables (reporting ids, K, weights, the ``cur`` / ``fresh``
masks, the anchor write ids, the last-occurrence map of repeated reporters)
and its gathered batches go to the device once, and no update reads the
device.  Stale anchors live in two device buffers of M + 1 rows, ``A``
(params) and ``N`` (ν): row i holds client i's dispatch-time model,
rewritten in place at its re-dispatch, and row M is the scratch row that
takes the writes of a client's non-last re-dispatches within one buffer.
Reports dispatched within the update that consumes them (``cur``: version
== update index) read the live model instead of the buffer.  The run owns
its state: the ν⁽ⁱ⁾ store, the uplink error-feedback stores and the anchor
buffers are updated in place, so no update copies an ``(M, P)`` buffer.

Wire compression (core/compress.py) follows the reference: a t = 0
broadcast through the downlink codec (``bc_params`` / ``bc_nu`` in the
state), anchors reset to it, the uplink codec on the reporting clients'
deltas and ν transmits with their own error-feedback rows, and one
broadcast event per update whose result the re-dispatched anchors get.

Failure scenarios (fed/scenarios.py) perturb the timeline (k′ aborts,
slowdowns, latency bursts, rejoin downtime) with the reference's keyed
draws, and each report's weight is scaled by its delivered fraction
k′/K.  A payload attack corrupts the reporters' deltas and ν transmits at
their ids, keyed by the update index, and the robust stage
(core/robust.py) screens them before the buffered aggregator; the final
guard keeps the old model, ν and ν⁽ⁱ⁾ wherever the new ones are
non-finite, before the broadcast and the re-dispatched anchors read them.
The health vectors are updated in place; a reporter repeated in one
buffer adds to its counters once per report and keeps its last report's
EWMA and quarantine rows.

Both parameter layouts run, with the host batcher or a device batcher
(``DeviceBatcher``: each report's rows drawn on the device from its keyed
(wave, client) indices, the reference's ``sample_row``): "flat" on
``(P,)`` / ``(M, P)`` buffers with one calibrated-update launch a local
step (and a mixed-precision master, ``FedConfig.master_dtype``: bfloat16
leaves over a float32 buffer), "tree" on the model's leaves (the anchor
buffers one ``(M + 1, …)`` tensor a leaf, the local steps
``stages.make_client_update``'s), whose wire stages cross the flat view
table (``_bridge``) as the reference's do.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import compress, flat, robust, rounds, stages
from repro_torch.core.fedopt import get_algorithm
from repro_torch.core.tree_util import expand, tree_leaves, tree_map, \
    tree_wsum
from repro_torch.data.partition import gaussian_k_schedule
from repro_torch.device import resolve_device
from repro_torch.fed.clock import ClientClock, Timeline, make_clock, \
    simulate_timeline
from repro_torch.fed.population import ClientPopulation
from repro_torch.fed.scenarios import Scenario, make_scenario
from repro_torch.fed.simulation import History, _check_finite_metric

PyTree = Any

# rows of the integer table a chunk sends to the device (one transfer)
_TABLE = ("ids", "k", "cur", "fresh", "write_ids", "last")


def staleness_weight(tau, mode: str = "constant", a: float = 0.5,
                     b: int = 4) -> np.ndarray:
    """Staleness discount s(τ) ≥ 0, s(0) = 1 (FedAsync §5 shapes)."""
    tau = np.asarray(tau, np.float64)
    if mode == "constant":
        return np.ones_like(tau)
    if mode == "poly":
        return (1.0 + tau) ** (-a)
    if mode == "hinge":
        return 1.0 / (1.0 + a * np.maximum(tau - b, 0.0))
    raise ValueError(f"unknown staleness mode {mode!r}")


def write_ids(dispatch_ids: np.ndarray, m: int) -> np.ndarray:
    """(T, B) anchor-buffer rows the re-dispatches write: a client
    dispatched more than once within one buffer writes its row once, at
    its LAST occurrence; the earlier ones land in the scratch row ``m``."""
    slots = np.arange(dispatch_ids.shape[1])
    return np.stack([np.where(stages.last_occurrence(row) == slots, row, m)
                     for row in dispatch_ids]).reshape(dispatch_ids.shape)


class BufferedAsyncSimulation:
    """``run(T)`` executes T buffered server updates of ``fed.algorithm``
    on one device (``device=None``: the card; ``"cpu"`` for the CPU).

    Mirrors ``FederatedSimulation``'s constructor, so a benchmark switches
    engines on ``fed.buffer_size`` alone.  ``clock`` defaults to the
    ``fed.speed_dist`` wall-clock model; ``k_schedule`` rows index
    per-client *dispatches* (client i's d-th task uses row d), so with
    buffer = M and identical speeds the data stream is the synchronous
    engine's.  ``batcher`` is a ``FederatedBatcher`` or ``DeviceBatcher``
    on the same device.

    Each ``run`` call simulates a fresh timeline from the CURRENT model
    (every client re-dispatched at simulated t = 0 on version 0, anchors
    reset to the current state)."""

    def __init__(self, loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                 params: PyTree, fed: FedConfig, batcher,
                 eval_fn: Optional[Callable[[PyTree], float]] = None,
                 k_schedule: Optional[np.ndarray] = None,
                 lam_schedule: Optional[Callable[[int], float]] = None,
                 clock: Optional[ClientClock] = None,
                 population: Optional[ClientPopulation] = None,
                 scenario: Optional[Scenario] = None, t_max: int = 10_000,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if batcher.device != self.device:
            raise ValueError(f"batcher is on {batcher.device}, the "
                             f"simulation on {self.device}")
        m = fed.n_clients
        self.fed = fed
        self.algo = get_algorithm(fed.algorithm, fed)
        self.batcher = batcher
        self.eval_fn = eval_fn
        self.lam_schedule = lam_schedule
        self.buffer = fed.buffer_size if fed.buffer_size > 0 else m
        if not 1 <= self.buffer <= m:
            raise ValueError(f"buffer_size {self.buffer} not in [1, {m}]")
        if k_schedule is None:
            k_schedule = gaussian_k_schedule(
                m, fed.k_mean, fed.k_var, t_max,
                mode=fed.k_mode, seed=fed.seed)
        self.k_schedule = k_schedule
        self.k_max = int(k_schedule.max())
        self.clock = clock if clock is not None else make_clock(
            m, dist=fed.speed_dist, sigma=fed.speed_sigma,
            latency=fed.comm_latency, seed=fed.seed)
        self.weights = (batcher.weights.cpu().numpy()
                        if fed.weights == "data"
                        else np.full((m,), 1.0 / m, np.float32))
        # partial participation (fed/population.py): the timeline keeps
        # only C = cohort_size tasks in flight, each freed slot re-filled
        # by the population's sampler
        self.population = (population if population is not None
                           else ClientPopulation.from_config(
                               fed, m=m, weights=self.weights))
        if self.population is not None:
            if self.population.m != m:
                raise ValueError(
                    f"population of {self.population.m} clients does not "
                    f"match fed.n_clients={m}")
            c = self.population.cohort_size
            if not self.population.full_participation:
                # only C tasks are in flight: a buffer spanning more than
                # one concurrency sweep would make Σ w̃ ≈ B/C > 1 and the
                # pseudo-delta step overshoot by that factor
                if fed.buffer_size <= 0:
                    self.buffer = c
                elif self.buffer > c:
                    raise ValueError(
                        f"buffer_size {self.buffer} exceeds the population "
                        f"concurrency C={c}; use buffer_size ≤ C (0 "
                        f"defaults to C under partial participation)")
            if clock is None and np.any(self.population.step_rate != 1.0):
                # the population's step-rate profile modulates the clock
                self.clock = ClientClock(
                    speeds=self.clock.speeds * self.population.step_rate,
                    latency=self.clock.latency)
        # failure scenario: perturbs the timeline and scales report weights
        # by the delivered fraction k′/K; None ("baseline") leaves the
        # whole pipeline untouched
        self.scenario = (scenario if scenario is not None
                         else make_scenario(fed))
        if self.scenario is not None:
            if self.scenario.m != m:
                raise ValueError(
                    f"scenario for {self.scenario.m} clients does not "
                    f"match fed.n_clients={m}")
            if (self.scenario.availability_fn is not None
                    and self.population is not None):
                self.population.availability_fn = \
                    self.scenario.availability_fn
        # payload corruption brackets the same wire as compression; the
        # defense and quarantine sit just before the buffered aggregator
        self._attack = (self.scenario
                        if self.scenario is not None
                        and self.scenario.corrupts_payload else None)
        self.robust = robust.RobustConfig.from_fed(fed)
        self.compression = compress.CompressionConfig.from_fed(fed)
        self.layout = fed.param_layout
        if self.layout == "flat":
            self._spec = flat.make_flat_spec(
                params, master_dtype=fed.master_dtype or None)
        elif (self.compression is not None or self.robust is not None
                or self._attack is not None):
            # the tree layout's wire stages cross the flat view table
            self._spec = flat.make_flat_spec(params)
        else:
            self._spec = None
        self._rb = robust.build_round_robust(self.robust, self._spec,
                                             self.algo.uses_nu)
        n_true = (self._spec.n if self._spec is not None
                  else sum(lv.numel() for lv in tree_leaves(params)))
        self._wire = compress.wire_cost(n_true, self.algo.uses_nu,
                                        self.compression)
        self._cs = compress.build_stages(self.compression, self._spec,
                                         self.algo.uses_nu)
        self._down_on = self._cs is not None and self._cs.down is not None
        self._up_on = self._cs is not None and self._cs.up is not None
        params = (flat.ravel(self._spec, params).to(self.device)
                  if self.layout == "flat"
                  else tree_map(lambda a: a.detach().to(self.device,
                                                        copy=True), params))
        self.state = rounds.init_state(
            params, m, self.algo, compression=self.compression,
            spec=self._spec, broadcast_carry=True, robust=self.robust)
        self.version = 0
        self._loss_fn = loss_fn
        self._client_update = (
            flat.make_flat_client_update(
                self._spec, loss_fn, self.algo, lr=fed.lr, k_max=self.k_max,
                per_client_anchor=True)
            if self.layout == "flat"
            else stages.make_client_update(
                loss_fn, self.algo, lr=fed.lr, k_max=self.k_max,
                per_client_anchor=True))
        self._aggregate = stages.BUFFERED_AGGREGATORS[self.algo.aggregator]
        # stale-ν⁽ⁱ⁾ decay is a PARTIAL-participation rule: with every
        # client in flight each row refreshes on its own report
        self._nu_decay = (fed.cohort_nu_decay
                          if self.population is not None
                          and not self.population.full_participation
                          else 0.0)
        self._anchors: Optional[PyTree] = None
        self._nu_anchors: Optional[PyTree] = None
        # host wave cache: per-wave index arrays, dropped after their last
        # consumer in the timeline and LRU-capped at M + 1 waves (under
        # heavy speed skew a straggler's wave can be asked for thousands
        # of updates after the fast clients consumed it; an evicted wave
        # is regenerated)
        self._wave_cache: dict[int, np.ndarray] = {}
        self._wave_left: Optional[np.ndarray] = None
        # a device batcher draws each report's rows on the device, keyed
        # by its (wave, client): no wave cache, no host gather
        self._device_sampler = callable(getattr(batcher, "sample_row",
                                                None))

    # -- the device-resident anchor buffers ----------------------------------

    def _bridge(self):
        """(ravel, ravel_rows, unravel, unravel_rows): identities on the
        flat layout, view-table crossings on the tree layout."""
        if self.layout == "flat":
            ident = lambda a: a  # noqa: E731
            return ident, ident, ident, ident
        return stages._flat_bridge(self._spec)

    def _broadcast_init(self) -> None:
        """The t = 0 dispatch ships a real compressed broadcast: one codec
        event through ``ef_down`` (and ``ef_down_nu``), kept as the
        ``bc_params`` / ``bc_nu`` carry the updates read."""
        state, cs = self.state, self._cs
        rv = self._bridge()[0]
        new_state = dict(state)
        new_state["bc_params"] = cs.down(rv(state["params"]), state,
                                         new_state)
        if self.algo.uses_nu:
            new_state["bc_nu"] = cs.down_nu(rv(state["nu"]), state,
                                            new_state)
        self.state = new_state

    def _reset_anchors(self) -> None:
        """(M + 1)-row anchor buffers, real tensors written in place (one a
        leaf on the tree layout): rows 0…M-1 hold each client's
        dispatch-time (params, ν), row M is the scratch row.  Under
        downlink compression the dispatch-time model is the COMPRESSED
        broadcast, not the raw master."""
        # the old buffers go before the new ones are made: at M = 100k each
        # is the size of the ν⁽ⁱ⁾ store
        self._anchors = self._nu_anchors = None
        rows = self.clock.m + 1
        ur = self._bridge()[2]

        def buffer(key: str, bc_key: str) -> PyTree:
            p0 = (ur(self.state[bc_key]) if self._down_on
                  else self.state[key])
            return tree_map(lambda p: p.expand((rows,) + tuple(p.shape))
                            .clone(), p0)

        self._anchors = buffer("params", "bc_params")
        if self.algo.uses_nu:
            self._nu_anchors = buffer("nu", "bc_nu")

    # -- one buffered server update ------------------------------------------

    def _update(self, state: dict, t: dict, sw: torch.Tensor, lam: float,
                batches: dict, noise: Optional[torch.Tensor] = None
                ) -> tuple[dict, dict]:
        """Update ``state`` on one buffer (``t``: its rows of the chunk's
        integer table on the device; ``last`` None where no reporter
        repeats; ``noise`` the attack's ``(2, B, P)`` noise rows, if it
        draws any); ``A`` and ``N`` are written in place."""
        algo, cs, lr = self.algo, self._cs, self.fed.lr
        rb, atk = self._rb, self._attack
        uses_nu = algo.uses_nu
        rv, rvr, ur, urr = self._bridge()
        A, N = self._anchors, self._nu_anchors
        ids, cur, fresh, wids, last = (t["ids"], t["cur"], t["fresh"],
                                       t["write_ids"], t["last"])
        params = state["params"]
        new_state = dict(state)
        # what a client dispatched on THIS version received: the
        # compressed broadcast carried in the state, or the raw model
        cur_p = ur(state["bc_params"]) if self._down_on else params
        cur_nu = ((ur(state["bc_nu"]) if self._down_on else state["nu"])
                  if uses_nu else None)

        def gather(buf, current):
            # dispatch-time anchors as fresh contiguous (B, …) rows;
            # reports dispatched within THIS update read the live model
            def one(b, c):
                rows = b.index_select(0, ids)
                return torch.where(expand(cur, rows), c[None], rows)
            return tree_map(one, buf, current)

        anchor_i = gather(A, cur_p)
        kf = t["k"].float()
        # Σ w̃ — usually in (0, 1], but a high-weight fast client
        # reporting twice into one buffer can push it past 1
        mass = sw.sum()
        kbar = torch.dot(sw, kf) / mass
        c_b = None
        if uses_nu:
            # the correction each client ran with: ν_{v_i} − ν⁽ⁱ⁾ (with
            # nu_decay the row has drifted toward ν since dispatch, the
            # reference's accepted approximation)
            c_b = tree_map(lambda na, nui: na - nui.index_select(0, ids),
                           gather(N, cur_nu), state["nu_i"])
        x_b, g0_b, acc_b, loss0 = self._client_update(anchor_i, c_b, batches,
                                                      t["k"], lam)

        r = state["round"]
        quar = rb.quarantined(state, r, ids) if rb is not None else None
        sw_eff = sw
        if cs is not None or rb is not None or atk is not None:
            # the uplink at the REPORTING ids, each reporter's own
            # error-feedback rows (a repeated reporter keeps its last
            # occurrence's residual, as the reference does); the attack
            # lands on the rows the codec sees, and the defense screens
            # what reaches the buffered aggregator
            a_rows = rvr(anchor_i)
            d = rvr(x_b) - a_rows
            if atk is not None:
                d = atk.corrupt_delta(r, d, self._spec.n, ids=ids,
                                      noise=None if noise is None
                                      else noise[0])
            if self._up_on:
                d = cs.up(d, state, new_state, ids=ids, last=last,
                          in_place=True)
            if rb is not None:
                d, sw_eff, qcount = rb.model(d, sw, state, new_state, r,
                                             ids, quar, last=last,
                                             in_place=True)
            x_srv = urr(a_rows + d)
        else:
            x_srv = x_b
        agg = self._aggregate(params, anchor_i, x_srv, kf, sw_eff, kbar)
        new_params = stages.server_update(algo, state, params, agg,
                                          new_state)
        if rb is not None:
            # guarded BEFORE the broadcast and the re-dispatched anchors
            # read the new model
            new_params = rb.guard(new_params, params)
        new_state["params"] = new_params
        new_state["round"] = state["round"] + 1

        if uses_nu:
            transmit, avg_g = stages.orientation_transmit(
                algo, params, x_b, g0_b, acc_b, c_b, kf, kbar, lr, lam,
                anchor_i=anchor_i)
            w_nu = sw
            if self._up_on or rb is not None or atk is not None:
                t_rows = rvr(transmit)
                if atk is not None:
                    t_rows = atk.corrupt_nu(r, t_rows, self._spec.n,
                                            ids=ids,
                                            noise=None if noise is None
                                            else noise[1])
                if self._up_on:
                    t_rows = cs.up_nu(t_rows, state, new_state, ids=ids,
                                      last=last, in_place=True)
                if rb is not None:
                    t_rows, w_nu = rb.nu(t_rows, sw, quar)
                transmit = urr(t_rows)
            new_nu = stages.nu_mass_mix(state["nu"],
                                        tree_wsum(w_nu, transmit), mass)
            if rb is not None:
                new_nu = rb.guard(new_nu, state["nu"])
                avg_g = robust.guarded_rows(avg_g, state["nu_i"], ids)
            new_state["nu"] = new_nu
            new_state["nu_i"] = stages.scatter_nu_rows(
                state["nu_i"], new_nu, avg_g, ids, self._nu_decay,
                in_place=True, last=last)

        # this update's broadcast: ONE compression event through the
        # server-side accumulator, kept for the next gather and written
        # into the re-dispatched anchors below
        if self._down_on:
            new_bc = cs.down(rv(new_params), state, new_state)
            new_state["bc_params"] = new_bc
            old_anchor, new_anchor = cur_p, ur(new_bc)
        else:
            old_anchor, new_anchor = params, new_params

        def scatter(buf, old, new):
            # re-dispatch anchors: the pre-update model, or the post-update
            # one for tie-upgraded dispatches; a client dispatched twice
            # writes once (``write_ids`` sends its earlier occurrences to
            # the scratch row M)
            def one(b, o, n):
                b.index_copy_(0, wids, torch.where(
                    expand(fresh, b[:1]), n[None], o[None]).to(b.dtype))
            tree_map(one, buf, old, new)

        scatter(A, old_anchor, new_anchor)
        if uses_nu:
            if self._down_on:
                new_bc_nu = cs.down_nu(rv(new_state["nu"]), state,
                                       new_state)
                new_state["bc_nu"] = new_bc_nu
                scatter(N, cur_nu, ur(new_bc_nu))
            else:
                scatter(N, state["nu"], new_state["nu"])

        metrics = {"loss": torch.dot(sw, loss0) / mass, "kbar": kbar,
                   "mass": mass}
        if rb is not None:
            metrics["quarantined"] = qcount
        return new_state, metrics

    # -- host-sampler batch assembly ------------------------------------------

    def _wave(self, d: int) -> np.ndarray:
        """(M, k_max, B) dataset rows of batch wave ``d``, cached until its
        last consumer in the timeline has arrived (LRU-capped)."""
        wave = self._wave_cache.pop(d, None)
        if wave is None:
            wave = self.batcher.round_indices(d, self.k_max)
        self._wave_left[d] -= 1
        if self._wave_left[d] > 0:
            self._wave_cache[d] = wave        # re-insert: most recent
            while len(self._wave_cache) > self.clock.m + 1:
                self._wave_cache.pop(next(iter(self._wave_cache)))
        return wave

    def _host_batches(self, tl: Timeline, u0: int, r: int) -> dict:
        """(R, B, k_max, batch, …) gathered rows for updates u0 … u0+r-1 —
        one host gather and one host→device transfer per chunk."""
        idx = np.empty((r, self.buffer, self.k_max, self.batcher.batch_size),
                       np.int64)
        for a in range(r):
            for j in range(self.buffer):
                idx[a, j] = self._wave(int(tl.waves[u0 + a, j]))[
                    int(tl.ids[u0 + a, j])]
        return self.batcher._gather(idx)

    # -- the timeline-driven chunked executor ---------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, t_updates: int, eval_every: int = 1,
            verbose: bool = False,
            chunk_updates: Optional[int] = None) -> History:
        """``chunk_updates=None`` chunks at the eval cadence; chunks never
        cross an eval boundary, so an explicit ``chunk_updates`` larger than
        ``eval_every`` is clamped when there is an ``eval_fn``.  A chunk
        computes exactly what its updates computed one by one."""
        hist = History()
        fed = self.fed
        tl = simulate_timeline(self.k_schedule, self.clock, self.buffer,
                               t_updates, population=self.population,
                               scenario=self.scenario)
        tau = tl.staleness
        s = staleness_weight(tau, fed.staleness, fed.staleness_a,
                             fed.staleness_b)
        # per-report base weights: raw ω for full participation, the
        # population's per-sampler renormalization under partial
        # participation
        base_w = (self.weights
                  if self.population is None
                  or self.population.full_participation
                  else self.population.report_weights())
        sw = base_w[tl.ids] * s
        if self.scenario is not None:
            # partial-work recovery: an aborted report keeps only the mass
            # it earned, w̃ · k′/K, in the aggregate and the ν mass-mix
            sw = sw * (tl.k_steps / np.maximum(tl.k_sched, 1))
        sw_all = sw.astype(np.float32)
        last = np.array([stages.last_occurrence(row) for row in tl.ids]
                        ).reshape(tl.ids.shape)
        table = np.stack([
            tl.ids, tl.k_steps,
            tl.versions == np.arange(t_updates)[:, None], tl.fresh,
            write_ids(tl.dispatch_ids, self.clock.m), last],
            axis=1).astype(np.int64)
        repeats = (last != np.arange(self.buffer)).any(axis=1)
        lam_all = np.asarray(
            [float(self.lam_schedule(u)) if self.lam_schedule
             else self.algo.lam for u in range(t_updates)], np.float32)
        if self._down_on:
            self._broadcast_init()
        self._reset_anchors()
        if not self._device_sampler:
            self._wave_cache = {}
            self._wave_left = np.bincount(tl.waves.ravel())

        chunk = max(int(chunk_updates if chunk_updates is not None
                        else eval_every), 1)
        if (chunk_updates is not None and chunk > eval_every
                and self.eval_fn is not None):
            warnings.warn(
                f"chunk_updates={chunk_updates} is clamped to the eval "
                f"cadence (eval_every={eval_every}): the host must sync at "
                f"every eval boundary", stacklevel=2)
        u = 0
        while u < t_updates:
            r = min(chunk, t_updates - u)
            if self.eval_fn is not None:
                r = min(r, eval_every - u % eval_every)
            sl = slice(u, u + r)
            tables = torch.from_numpy(table[sl]).to(self.device)
            sws = torch.from_numpy(sw_all[sl]).to(self.device)
            batches = (self.batcher.sample_rows(tl.waves[sl], tl.ids[sl],
                                                self.k_max)
                       if self._device_sampler
                       else self._host_batches(tl, u, r))
            noise = None
            if self._attack is not None and self._attack.needs_noise:
                # keyed by the state's update counter, as in the reference
                noise = torch.from_numpy(np.stack([
                    self._attack.payload_noise(self.version + u + a,
                                               tl.ids[u + a], self._spec.p)
                    for a in range(r)])).to(self.device)
            tic = time.perf_counter()
            per_update = []
            for a in range(r):
                rows = {name: tables[a, i] for i, name in enumerate(_TABLE)}
                rows["cur"], rows["fresh"] = (rows["cur"].bool(),
                                              rows["fresh"].bool())
                if not repeats[u + a]:
                    rows["last"] = None
                self.state, metrics = self._update(
                    self.state, rows, sws[a], float(lam_all[u + a]),
                    {key: v[a] for key, v in batches.items()},
                    None if noise is None else noise[a])
                per_update.append(metrics)
            self._sync()
            dt = time.perf_counter() - tic
            for key in ("loss", "kbar", "mass", "quarantined"):
                if key in per_update[0]:
                    getattr(hist, key).extend(torch.stack(
                        [mt[key] for mt in per_update]).double().tolist())
            hist.wall.extend([dt / r] * r)
            hist.sim_time.extend(tl.arrival_t[sl, -1].tolist())
            hist.staleness.extend(tau[sl].mean(axis=1).tolist())
            # wire traffic per update: B reports up, B re-dispatch
            # downloads of the (possibly compressed) new broadcast
            hist.bytes_up.extend(
                [self.buffer * self._wire["uplink_per_client"]] * r)
            hist.bytes_down.extend(
                [self.buffer * self._wire["downlink_per_client"]] * r)
            if self.scenario is not None:
                hist.dropped.extend(tl.aborted[sl].mean(axis=1).tolist())
            u += r
            if self.eval_fn is not None and u % eval_every == 0:
                value = float(self.eval_fn(self.params))
                _check_finite_metric(value, u)
                hist.metric.append(value)
            if verbose and (u % 10 < r or u == t_updates):
                mtr = hist.metric[-1] if hist.metric else float("nan")
                print(f"  update {u - 1:4d}  t={hist.sim_time[-1]:8.2f}  "
                      f"loss={hist.loss[-1]:.4f}  metric={mtr:.4f}  "
                      f"stale={hist.staleness[-1]:.1f}")
        self.version += t_updates
        return hist

    @property
    def params(self) -> PyTree:
        """Current global model as a tree: the state's own on the tree
        layout, new tensors that own their data on the flat layout."""
        if self.layout == "flat":
            return flat.unravel(self._spec, self.state["params"])
        return self.state["params"]
