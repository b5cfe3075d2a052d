"""Sync-vs-async deterioration table (beyond-paper extension).

Claim validated: the FedaGrac calibration machinery survives the move from
synchronous rounds to buffered semi-asynchronous execution, and the buffered
engine converts straggler idle time into extra server updates.  On a
lognormal-speed fleet the synchronous round clock is set by the slowest
client; the buffered engine (FedBuff semantics: the server steps on every
M'-th REPORT, fast clients report repeatedly) never waits.  Three checks:

1. **Sanity** — buffer = M with identical speeds reproduces the synchronous
   FedaGrac trajectory (the ``async_full`` row; the drift line below).
2. **Deterioration** — staleness and fast-client participation bias cost
   statistical efficiency: buffered rows need several × more server
   updates to the target than synchronous FedaGrac, single-report FedAsync
   (buffer = 1) deteriorates furthest, and full-strength calibration (λ = 1)
   against a stale ν trails the λ = 0.5 row.
3. **Rehabilitation** — at a matched wall-clock horizon (``acc_at_budget``:
   accuracy once simulated time reaches the synchronous run's total budget)
   tempered buffered FedaGrac (λ = 0.5, buffer = 0.8 M, hinge) ends above
   the synchronous final accuracy.

Columns: algorithm, mode, buffer, staleness, updates→target, simulated
seconds→target, accuracy at the sync wall-clock budget, mean staleness.

The twin of ``benchmarks/table_async.py``, on the port (the flat layout,
``fed.async_engine.BufferedAsyncSimulation``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import M_CLIENTS, emit, make_task
from repro_torch.configs.base import FedConfig
from repro_torch.fed import BufferedAsyncSimulation, FederatedSimulation
from repro_torch.fed.clock import make_clock

TARGET = 0.75
T, T_QUICK = 40, 20
HEADER = ("algorithm", "mode", "buffer", "staleness",
          f"updates_to_{int(TARGET * 100)}",
          f"sim_s_to_{int(TARGET * 100)}", "acc_at_budget", "mean_stale")


def _fed(task, algorithm, lam=1.0, **kw):
    return FedConfig(algorithm=algorithm, n_clients=task.batcher.m,
                     lr=task.lr, calibration_rate=lam, weights="data",
                     param_layout="flat", **kw)


def _to_target(hist, sim_times):
    r = hist.rounds_to_target(TARGET)
    if r is None:
        return f">{len(hist.metric)}", ""
    return r, f"{sim_times[r - 1]:.1f}"


def run(quick: bool = False, device=None) -> tuple[list[tuple], list[str]]:
    """(rows, the closing ``#`` lines: the budget and the buffer = M drift
    check)."""
    t_rounds = T_QUICK if quick else T
    m = M_CLIENTS
    ks = np.full((t_rounds * m + 1, m), 40, np.int32)  # fixed K: round-async
    clock = make_clock(m, dist="lognormal", sigma=1.0, seed=7)
    sync_round_s = clock.round_time(ks[0])            # straggler-bound
    budget = t_rounds * sync_round_s                  # sync total wall-clock
    rows = []

    def run_sync(algorithm):
        task = make_task("lr", noniid=True, device=device)
        sim = FederatedSimulation(task.loss_fn, task.params,
                                  _fed(task, algorithm), task.batcher,
                                  eval_fn=task.eval_fn, k_schedule=ks,
                                  device=task.device)
        hist = sim.run(t_rounds)
        upd, secs = _to_target(
            hist, [sync_round_s * (t + 1) for t in range(t_rounds)])
        rows.append((algorithm, "sync", m, "-", upd, secs,
                     f"{hist.metric[-1]:.4f}", "0.0"))
        return hist

    def run_async(algorithm, label, buffer, staleness, *, lam=1.0,
                  fixed_speed=False):
        task = make_task("lr", noniid=True, device=device)
        fed = _fed(task, algorithm, lam=lam, buffer_size=buffer,
                   staleness=staleness, staleness_a=0.5, staleness_b=2)
        c = make_clock(m, dist="fixed") if fixed_speed else clock
        sim = BufferedAsyncSimulation(task.loss_fn, task.params, fed,
                                      task.batcher, eval_fn=task.eval_fn,
                                      k_schedule=ks, clock=c,
                                      device=task.device)
        if fixed_speed:
            hist = sim.run(t_rounds)                  # the sanity row
        else:
            # a generous update budget, judged at the wall-clock budget
            hist = sim.run(5 * t_rounds * m // max(buffer, 2))
        upd, secs = _to_target(hist, hist.sim_time)
        within = [a for a, t in zip(hist.metric, hist.sim_time)
                  if t <= budget] or [hist.metric[0]]
        rows.append((f"{algorithm}(λ={lam:g})"
                     if algorithm.startswith("fedagrac") else algorithm,
                     label, buffer, staleness, upd, secs,
                     f"{within[-1]:.4f}",
                     f"{np.mean(hist.staleness):.2f}"))
        return hist

    h_sync = run_sync("fedagrac")
    run_sync("fedavg")
    # 1: full buffer + equal speeds == the synchronous engine
    h_full = run_async("fedagrac", "async_full", m, "constant",
                       fixed_speed=True)
    # 2/3: partial buffers on the heterogeneous fleet
    run_async("fedagrac", "async_buf", 4 * m // 5, "hinge", lam=0.5)
    run_async("fedagrac", "async_buf", 4 * m // 5, "hinge", lam=1.0)
    run_async("fedavg", "async_buf", m // 2, "constant")   # FedBuff
    run_async("fedavg", "async_buf", m // 2, "hinge")      # + discount
    run_async("fedagrac", "async_one", 1, "poly", lam=0.5)  # FedAsync

    drift = abs(h_sync.metric[-1] - h_full.metric[-1])
    notes = [f"# sync wall-clock budget: {budget:.0f} s "
             f"({t_rounds} straggler-bound rounds)",
             f"# buffer=M vs sync final-acc drift: {drift:.2e} "
             f"({'OK' if drift < 1e-3 else 'MISMATCH'})"]
    return rows, notes


def main(quick: bool = False, device=None) -> None:
    rows, notes = run(quick, device)
    emit(rows, HEADER)
    for line in notes:
        print(line)
