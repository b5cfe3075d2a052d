"""Deterministic load generation + trace replay for the serving engines
(``repro.serving.loadgen`` counterpart: numpy only, copied as it is).

``LoadGen`` draws a seeded arrival trace over a client population —
Poisson arrivals per scheduler tick, power-law client popularity (a few
hot clients, a long cold tail, the shape personalization caches live or
die by), uniform prompt/output lengths — entirely from one
``np.random.default_rng(seed)`` stream, so a trace is a pure function of
its config: benchmarks and tests replay byte-identical request streams
without storing them.

``replay`` drives an engine tick-by-tick against a trace: requests are
submitted when the scheduler clock reaches their arrival tick, idle gaps
fast-forward the clock (no busy-waiting), and an optional snapshot
hot-swap fires at a configured tick — mid-stream, exactly as a training
round completing would.  Per-tick wall time and pool utilization are
recorded; ``latency_stats`` reduces any sample list to p50/p99/mean."""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from repro_torch.serving.engine import Request, ServeEngine


@dataclasses.dataclass
class LoadGen:
    """Seeded request-stream generator over ``population`` clients.

    ``rate`` is the mean arrivals per scheduler tick; ``skew`` ≥ 1 bends
    client popularity toward low ids (rank = ⌊M·u^skew⌋ — skew=1 is
    uniform, larger concentrates traffic on fewer clients)."""
    population: int = 32
    rate: float = 0.5
    prompt_len: tuple[int, int] = (4, 16)       # inclusive range
    max_new: tuple[int, int] = (4, 12)
    vocab: int = 256
    seed: int = 0
    skew: float = 1.0

    def generate(self, n_requests: int) -> list[tuple[int, Request]]:
        """``n_requests`` arrivals as (arrival_tick, Request), tick-sorted,
        uids dense in submission order."""
        rng = np.random.default_rng(self.seed)
        out: list[tuple[int, Request]] = []
        tick, uid = 0, 0
        while uid < n_requests:
            k = rng.poisson(self.rate)
            for _ in range(min(k, n_requests - uid)):
                cid = int(self.population * rng.random() ** self.skew)
                cid = min(cid, self.population - 1)
                n = int(rng.integers(self.prompt_len[0],
                                     self.prompt_len[1] + 1))
                m = int(rng.integers(self.max_new[0], self.max_new[1] + 1))
                prompt = rng.integers(1, self.vocab, size=n).astype(np.int32)
                out.append((tick, Request(uid=uid, prompt=prompt,
                                          max_new_tokens=m, client_id=cid)))
                uid += 1
            tick += 1
        return out


def replay(engine: ServeEngine, trace: list[tuple[int, Request]], *,
           swap_at: Optional[int] = None, snapshot: Optional[dict] = None,
           max_ticks: int = 100_000) -> dict[str, Any]:
    """Drive ``engine`` through ``trace`` until drained.  Returns per-tick
    wall seconds, post-step utilization, completions, and totals."""
    pending = deque(sorted(trace, key=lambda e: e[0]))
    tick_wall: list[float] = []
    util: list[float] = []
    n0_done, t0_tick = len(engine.done), engine.ticks
    n0_dropped = getattr(engine, "dropped", 0)
    swapped = swap_at is None
    wall0 = time.perf_counter()
    while pending or engine.queue \
            or any(a is not None for a in engine.active):
        if engine.ticks - t0_tick >= max_ticks:
            break
        if not swapped and engine.ticks >= swap_at:
            engine.swap(snapshot)           # between ticks, mid-stream
            swapped = True
        while pending and pending[0][0] <= engine.ticks:
            engine.submit(pending.popleft()[1])
        if not engine.queue \
                and all(a is None for a in engine.active) and pending:
            # idle gap: fast-forward the clock to the next arrival
            engine.ticks = max(engine.ticks + 1, pending[0][0])
            continue
        w0 = time.perf_counter()
        engine.step()
        tick_wall.append(time.perf_counter() - w0)
        util.append(engine.utilization)
    wall = time.perf_counter() - wall0
    if not swapped:                          # swap point past the drain
        engine.swap(snapshot)
    completions = engine.done[n0_done:]
    return {
        "completions": completions,
        "n_requests": len(completions),
        "ticks": engine.ticks - t0_tick,
        "wall_s": wall,
        "requests_per_s": len(completions) / wall if wall > 0 else 0.0,
        "tick_wall": tick_wall,
        "utilization": util,
        "mean_utilization": float(np.mean(util)) if util else 0.0,
        "dropped": getattr(engine, "dropped", 0) - n0_dropped,
    }


def latency_stats(samples: list[float],
                  dropped: int = 0) -> dict[str, float]:
    if not samples:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0,
                "dropped": float(dropped)}
    arr = np.asarray(samples, np.float64)
    return {"p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "mean": float(arr.mean()),
            "dropped": float(dropped)}
