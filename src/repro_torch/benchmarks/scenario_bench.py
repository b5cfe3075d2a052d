"""Survival table: algorithms under failure scenarios.

Claim validated: the failure-scenario engine (fed/scenarios.py) turns
device-model faults — mid-round dropout with partial-work recovery,
adversarial straggler spikes, flaky-network latency bursts, correlated
diurnal availability — into reproducible benchmark conditions, and the
partial-work recovery rule (a client contributes its k′-step prefix at
delivered-fraction weight k′/K) keeps every algorithm convergent where a
discard-on-failure server would lose the work.  The table crosses
algorithm × staleness discount × scenario on the buffered-async engine
(lognormal fleet, buffer = M/2) and reports final accuracy, server updates
to the target, simulated seconds to the target, and the realized abort
fraction.  Two survival checks:

1. **Graceful degradation** — under every fault model each algorithm still
   reaches the target; dropout and spikes cost updates (lost step mass),
   flaky networks cost only simulated seconds.
2. **Calibration survives faults** — FedaGrac's final accuracy under each
   scenario stays within a small margin of its own baseline row.

The twin of ``benchmarks/scenario_bench.py``, on the port (the flat
layout, ``fed.async_engine.BufferedAsyncSimulation``): the same task, K,
clock and scenario knobs, and the scenarios' draws are the reference's
keyed ones, so its timelines are the reference's.  It writes no
``BENCH_scenarios.json``; ``--out PATH`` writes its JSON report there.

    PYTHONPATH=src python -m repro_torch.benchmarks.scenario_bench \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.benchmarks.common import M_CLIENTS, emit, make_task
from repro_torch.configs.base import FedConfig
from repro_torch.fed import BufferedAsyncSimulation, make_clock

TARGET = 0.70
K_MEAN = 40
T, T_QUICK = 120, 80
HEADER = ("algorithm", "staleness", "scenario", "final_acc",
          f"updates_to_{int(TARGET * 100)}",
          f"sim_s_to_{int(TARGET * 100)}", "dropped_frac")

# scenario name -> FedConfig knobs (all resolved by make_scenario)
SCENARIO_KNOBS = {
    "baseline": {},
    "dropout": {"dropout_rate": 0.3, "rejoin_delay": 2.0},
    "spike": {"scenario_rate": 0.2, "scenario_magnitude": 8.0},
    "flaky": {"scenario_rate": 0.3, "scenario_magnitude": 5.0},
    "diurnal": {"scenario_period": 16.0,
                "cohort_size": 8, "cohort_sampler": "availability"},
}


def _one(algorithm: str, staleness: str, scenario: str, t_updates: int,
         device, lam: float = 0.5) -> dict:
    m = M_CLIENTS
    task = make_task("lr", noniid=True, device=device)
    knobs = dict(SCENARIO_KNOBS[scenario])
    buffer = min(m // 2, knobs.get("cohort_size", m))
    fed = FedConfig(algorithm=algorithm, n_clients=m, lr=task.lr,
                    calibration_rate=lam, weights="data",
                    buffer_size=buffer, staleness=staleness,
                    staleness_a=0.5, staleness_b=2, param_layout="flat",
                    scenario=scenario, **knobs)
    ks = np.full((t_updates * m + 1, m), K_MEAN, np.int32)
    clock = make_clock(m, dist="lognormal", sigma=1.0, seed=7)
    sim = BufferedAsyncSimulation(task.loss_fn, task.params, fed,
                                  task.batcher, eval_fn=task.eval_fn,
                                  k_schedule=ks, clock=clock,
                                  device=task.device)
    hist = sim.run(t_updates)
    r = hist.rounds_to_target(TARGET)
    return {
        "algorithm": algorithm,
        "staleness": staleness,
        "scenario": scenario,
        "final_acc": float(hist.metric[-1]),
        "updates_to_target": r,
        "sim_s_to_target": (float(hist.sim_time[r - 1])
                            if r is not None else None),
        "sim_s_total": float(hist.sim_time[-1]),
        "dropped_frac": (float(np.mean(hist.dropped))
                         if hist.dropped else 0.0),
        "mean_mass": float(np.mean(hist.mass)),
    }


def run(quick: bool = False, device=None) -> tuple[list[tuple], dict]:
    """(rows, the JSON report)."""
    algorithms = (("fedavg", "fedagrac") if quick
                  else ("fedavg", "fednova", "fedagrac"))
    staleness_modes = ("poly",) if quick else ("constant", "poly")
    t_updates = T_QUICK if quick else T

    rows, table = [], []
    for algorithm in algorithms:
        for staleness in staleness_modes:
            for scenario in SCENARIO_KNOBS:
                r = _one(algorithm, staleness, scenario, t_updates, device)
                table.append(r)
                rt = r["updates_to_target"]
                rows.append((
                    algorithm, staleness, scenario,
                    f"{r['final_acc']:.4f}",
                    rt if rt is not None else f">{t_updates}",
                    (f"{r['sim_s_to_target']:.1f}"
                     if r["sim_s_to_target"] is not None else "-"),
                    f"{r['dropped_frac']:.3f}",
                ))

    def acc(algorithm, scenario, staleness=staleness_modes[-1]):
        return next(r["final_acc"] for r in table
                    if r["algorithm"] == algorithm
                    and r["scenario"] == scenario
                    and r["staleness"] == staleness)

    survival = {
        "all_reach_target": all(r["updates_to_target"] is not None
                                for r in table),
        "fedagrac_beats_fedavg": {
            s: acc("fedagrac", s) >= acc("fedavg", s)
            for s in SCENARIO_KNOBS if s != "baseline"},
        "max_acc_drop_vs_baseline": {
            a: max(acc(a, "baseline", st) - acc(a, s, st)
                   for s in SCENARIO_KNOBS for st in staleness_modes)
            for a in algorithms},
    }
    report = {"table": table, "survival": survival,
              "meta": {"quick": quick, "target": TARGET,
                       "t_updates": t_updates, "k_local_steps": K_MEAN,
                       "clock": "lognormal(sigma=1.0, seed=7)",
                       "scenario_knobs": SCENARIO_KNOBS}}
    return rows, report


def main(quick: bool = False, device=None, out: Optional[str] = None
         ) -> None:
    rows, report = run(quick, device)
    emit(rows, HEADER)
    survival = report["survival"]
    beats = sum(survival["fedagrac_beats_fedavg"].values())
    print(f"# all cells reach {TARGET:.2f}: "
          f"{'OK' if survival['all_reach_target'] else 'NO'}; fedagrac >= "
          f"fedavg on {beats}/{len(survival['fedagrac_beats_fedavg'])} "
          f"fault scenarios")
    if out is not None:
        Path(out).write_text(json.dumps(report, indent=2, sort_keys=True)
                             + "\n")
        print(f"# wrote {out}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here")
    args = ap.parse_args()
    main(args.quick, args.device, args.out)
