"""Client wall-clock model for the buffered semi-asynchronous engine
(``repro.fed.clock`` counterpart, a copy: the port imports nothing of the
JAX package).

The paper's *step* asynchronism keeps rounds synchronous in wall-clock time:
fast hardware spends the same round duration on more local steps (K_i ∝
speed).  *Round* asynchronism (Xie et al. FedAsync; Nguyen et al. FedBuff)
is the complementary regime modeled here: K_i is fixed by the schedule and
heterogeneous hardware makes report times diverge, so the server sees a
stream of stale updates instead of aligned rounds.

``ClientClock`` maps (client, K_i) → simulated duration; the async engine
orders report events with it.  Speeds are *steps per unit time*; a fixed
per-report ``latency`` models the upload/download overhead.

``simulate_timeline`` is the event loop itself: the buffered-async
execution order is fully determined by ``(k_schedule, clock, buffer_size)``
— no model state enters the arrival ordering — so the whole heapq
simulation is precomputed here in one host pass and the engine
(fed/async_engine.py) executes the resulting arrays in chunks.  The code is
numpy only, with the reference's ``default_rng`` streams, so every array of
a ``Timeline`` equals the reference's; a failure scenario's per-wave k′,
speed and latency rows (fed/scenarios.py) are the reference's keyed
draws, so they do too.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientClock:
    """Per-client execution-speed model."""
    speeds: np.ndarray                    # (M,) local steps per unit time
    latency: np.ndarray                   # (M,) fixed per-report overhead

    @property
    def m(self) -> int:
        return len(self.speeds)

    def duration(self, client: int, k_steps: int) -> float:
        """Simulated seconds between dispatch and report of one task."""
        return float(k_steps / self.speeds[client]
                     + self.latency[client])

    def round_time(self, k_steps: np.ndarray) -> float:
        """Synchronous-round duration: the straggler defines the round."""
        k = np.broadcast_to(np.asarray(k_steps, np.float64), (self.m,))
        return float(np.max(k / self.speeds + self.latency))


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Precomputed buffered-async execution schedule for T server updates.

    Row ``u`` describes update ``u``'s buffer of B reports in arrival order
    (heap order: time, then dispatch sequence):

    * ``ids``        (T, B) int — reporting client of each buffer slot.
    * ``versions``   (T, B) int — model version the report was dispatched
      with (tie-upgrade rule applied, so ∈ {dispatch update, +1}).
    * ``waves``      (T, B) int — dispatch wave d: the report trained on row
      ``ids`` of batch wave ``d`` and K = ``k_schedule[d % len, id]``.
    * ``k_steps``    (T, B) int — that K, denormalized for convenience.
    * ``staleness``  (T, B) int — τ = u − version.
    * ``arrival_t``  (T, B) f64 — simulated arrival times; ``arrival_t[u,-1]``
      is the server-update timestamp (``History.sim_time``).
    * ``fresh``      (T, B) bool — the task DISPATCHED at this event carries
      the post-update model (the tie-upgrade rule fired), i.e. its anchor is
      the update's output rather than its input.
    * ``dispatch_ids`` (T, B) int — the client dispatched at each report
      event.  Without a population this is ``ids`` (the reporter is
      re-dispatched immediately); with partial participation
      (fed/population.py) the freed slot goes to a sampler-chosen client, so
      the concurrency cap C becomes a population property.
    * ``k_sched``    (T, B) int — the SCHEDULED K_i of each report; equals
      ``k_steps`` except under a failure scenario, where ``k_steps``
      carries the effective k′ ≤ K_i actually completed.
    * ``aborted``    (T, B) bool — the report is a mid-round dropout
      (k′ < K_i); its partial delta still enters the buffer.
    """
    ids: np.ndarray
    versions: np.ndarray
    waves: np.ndarray
    k_steps: np.ndarray
    staleness: np.ndarray
    arrival_t: np.ndarray
    fresh: np.ndarray
    dispatch_ids: np.ndarray
    k_sched: np.ndarray = None
    aborted: np.ndarray = None

    @property
    def t_updates(self) -> int:
        return self.ids.shape[0]

    @property
    def buffer(self) -> int:
        return self.ids.shape[1]


def simulate_timeline(k_schedule: np.ndarray, clock: ClientClock,
                      buffer: int, t_updates: int,
                      population=None, scenario=None) -> Timeline:
    """Run the FedBuff event loop for ``t_updates`` server updates.

    Event-accurate semantics (the reference's, array for array): every
    popped report frees a concurrency slot which is re-filled IMMEDIATELY
    on the current (pre-update) model — the server only steps when the
    buffer fills, so a fast client's next report can land inside this same
    buffer ('M reports' counts reports, not distinct clients).  A task
    dispatched at the very instant the buffer filled starts as the server
    steps at the same timestamp — it receives the FRESH post-update model
    (zero elapsed time, so only the anchor version changes).  With buffer =
    M and equal speeds every arrival ties, preserving the exact synchronous
    reduction.

    Without ``population`` the freed slot goes back to the reporter (all M
    clients always in flight).  With a ``ClientPopulation`` only C =
    ``population.cohort_size`` tasks are in flight and each freed slot is
    re-filled by ``population.pick_dispatch`` (the sampler choosing among
    idle clients); ``sampler="all"`` (C = M) leaves the reporter as the
    only idle client, reproducing the full-participation stream bit for
    bit.

    With a ``scenario`` (fed/scenarios.py) each dispatch is perturbed by
    the scenario's per-(wave, client) draws: the task runs only k′ ≤ K
    steps (a mid-round dropout — an **abort event** whose partial work is
    still delivered), its duration is ``k′ / (speed · factor) + latency +
    extra``, and an aborted client **rejoins** only after
    ``scenario.rejoin_delay`` simulated seconds of downtime (its next task
    starts late by the remaining downtime).  ``scenario=None`` leaves every
    code path and float untouched.
    """
    m = clock.m
    k_schedule = np.asarray(k_schedule)
    heap: list[tuple[float, int, int]] = []
    # client -> (version, K_eff, wave, t_dispatch, K_sched)
    inflight: dict[int, tuple[int, int, int, float, int]] = {}
    wave_ctr = np.zeros(m, np.int64)
    busy = np.zeros(m, bool)
    down_until = np.zeros(m, np.float64)   # abort rejoin gates (scenario)
    seq = 0

    # per-wave scenario rows (k′ / speed factor / latency extra), drawn
    # once per wave and LRU-cached: clients reach the same wave at very
    # different simulated times under speed skew, so an evicted wave is
    # drawn again
    scn_cache: dict[int, tuple] = {}

    def scn_rows(d: int) -> tuple:
        rows = scn_cache.pop(d, None)
        if rows is None:
            base = np.asarray(k_schedule[d % len(k_schedule)])
            rows = (scenario.host_k_eff(d, base),
                    scenario.host_speed_factor(d),
                    scenario.host_latency_extra(d))
        scn_cache[d] = rows
        while len(scn_cache) > 128:
            scn_cache.pop(next(iter(scn_cache)))
        return rows

    def dispatch(i: int, t_now: float, version: int) -> None:
        nonlocal seq
        d = int(wave_ctr[i])
        k_s = int(k_schedule[d % len(k_schedule), i])
        if scenario is None:
            k = k_s
            dur = clock.duration(i, k)
        else:
            keff, f, lx = scn_rows(d)
            k = int(keff[i])
            dur = float(k / (clock.speeds[i] * f[i])
                        + clock.latency[i] + lx[i])
            wait = down_until[i] - t_now
            if wait > 0:                   # still offline after an abort
                dur += wait
            if k < k_s and scenario.rejoin_delay > 0:
                down_until[i] = t_now + dur + scenario.rejoin_delay
        inflight[i] = (version, k, d, t_now, k_s)
        wave_ctr[i] += 1
        busy[i] = True
        heapq.heappush(heap, (t_now + dur, seq, i))
        seq += 1

    if population is None:
        initial = np.arange(m)
        rng = None
    else:
        if population.m != m:
            raise ValueError(f"population of {population.m} clients does "
                             f"not match the clock's m={m}")
        rng = np.random.default_rng((population.seed, 0x5eed))
        initial = population.initial_dispatch(rng)
    for i in initial:
        dispatch(int(i), 0.0, 0)

    shape = (t_updates, buffer)
    ids = np.zeros(shape, np.int64)
    dispatch_ids = np.zeros(shape, np.int64)
    versions = np.zeros(shape, np.int64)
    waves = np.zeros(shape, np.int64)
    k_steps = np.zeros(shape, np.int64)
    k_sched = np.zeros(shape, np.int64)
    arrival_t = np.zeros(shape, np.float64)
    fresh = np.zeros(shape, bool)

    for u in range(t_updates):
        pending: list[tuple[float, int, int, tuple]] = []
        while len(pending) < buffer:
            t_arr, _, i = heapq.heappop(heap)
            task = inflight.pop(i)
            busy[i] = False
            nxt = (i if population is None
                   else population.pick_dispatch(rng, busy, i, phase=u))
            pending.append((t_arr, i, nxt, task))
            dispatch(nxt, t_arr, u)
        now = pending[-1][0]
        for j, (t_arr, i, nxt, (v, k, d, _, k_s)) in enumerate(pending):
            ids[u, j] = i
            dispatch_ids[u, j] = nxt
            versions[u, j] = v
            waves[u, j] = d
            k_steps[u, j] = k
            k_sched[u, j] = k_s
            arrival_t[u, j] = t_arr
        # tie upgrade (see docstring); idempotent for duplicate dispatches —
        # the check always lands on the client's NEWEST in-flight task
        for t_arr, _, nxt, _ in pending:
            if t_arr == now and nxt in inflight:
                ver, k, d, t_disp, k_s = inflight[nxt]
                if ver == u and t_disp == t_arr:
                    inflight[nxt] = (u + 1, k, d, t_disp, k_s)
        # a dispatched task already consumed within this same buffer (and
        # whose client was not re-dispatched) has no in-flight entry: its
        # anchor row is rewritten before it is ever read again
        fresh[u] = [nxt in inflight and inflight[nxt][0] == u + 1
                    for nxt in dispatch_ids[u]]

    staleness = np.arange(t_updates, dtype=np.int64)[:, None] - versions
    return Timeline(ids=ids, versions=versions, waves=waves,
                    k_steps=k_steps, staleness=staleness,
                    arrival_t=arrival_t, fresh=fresh,
                    dispatch_ids=dispatch_ids, k_sched=k_sched,
                    aborted=k_steps < k_sched)


def make_clock(m: int, *, dist: str = "lognormal", sigma: float = 0.5,
               latency: float = 0.0, seed: int = 0,
               speeds=None) -> ClientClock:
    """Sample per-client speeds.

    fixed     : every client identical (async arrivals degenerate to
                dispatch order — the sync-equivalence regime).
    uniform   : speeds ~ U[0.5, 1.5].
    lognormal : speeds ~ LogNormal(0, σ) — the long-tail straggler regime
                reported for production FL fleets.
    bimodal   : m−1 unit-speed devices + one 10× "GPU client" (the paper's
                Raspberry-Pi + GPU hardware mix, §6.1).
    trace     : an explicit per-client ``speeds`` array (steps per unit
                time) measured from a real fleet — the empirical-trace
                entry point; ``latency`` may also be a (m,) array there.
    """
    if dist == "trace":
        if speeds is None:
            raise ValueError("dist='trace' needs an explicit speeds array "
                             "(per-client steps per unit time)")
        speeds = np.asarray(speeds, np.float64)
        if speeds.shape != (m,):
            raise ValueError(f"trace speeds must have shape ({m},), got "
                             f"{speeds.shape}")
        if not np.all(speeds > 0):
            raise ValueError("trace speeds must be positive")
    elif speeds is not None:
        raise ValueError(f"explicit speeds are only valid with "
                         f"dist='trace' (got dist={dist!r})")
    rng = np.random.default_rng(seed)
    if dist == "trace":
        pass
    elif dist == "fixed":
        speeds = np.ones(m)
    elif dist == "uniform":
        speeds = rng.uniform(0.5, 1.5, m)
    elif dist == "lognormal":
        speeds = rng.lognormal(0.0, sigma, m)
    elif dist == "bimodal":
        speeds = np.ones(m)
        speeds[-1] = 10.0
    else:
        raise ValueError(f"unknown speed_dist {dist!r}; valid options: "
                         f"['bimodal', 'fixed', 'lognormal', 'trace', "
                         f"'uniform']")
    lat = np.broadcast_to(np.asarray(latency, np.float64), (m,)).copy()
    if not np.all(lat >= 0):
        raise ValueError("latency must be ≥ 0")
    return ClientClock(speeds=speeds, latency=lat)
