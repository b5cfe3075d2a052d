"""Attack × defense survival grid: Byzantine-robust aggregation
(core/robust.py, fed/scenarios.py).

Claim validated: FedaGrac is *more* exposed to corrupted payloads than
plain FedAvg — a poisoned report enters the model average and the
broadcast orientation ν, so one bad client deteriorates every client's
local direction next round — and the robust-aggregation layer
rehabilitates it: with a defense in front of the aggregator (and the
health quarantine absorbing repeat offenders), fedagrac reaches the
accuracy target under attacks where the undefended run diverges outright
(NaN injection poisons the master within one round; the eval guard
raises) or stalls below target.

The grid crosses payload-corruption scenario × defense on the synchronous
engine and reports final accuracy (the mean of the last 5 evaluations),
rounds to target, quarantined-client rounds, and whether the run survived
(``survived`` reads the params' finiteness: the accuracy of NaN logits is
finite).  A second table ablates the ν defense (``nu_defense=False``).

The twin of ``benchmarks/robust_bench.py``, on the port (the flat layout):
the same task, K schedule and attack knobs, and the attacks' corrupt sets
are the reference's.  It writes no ``BENCH_robust.json``; ``--out PATH``
writes its JSON report there.

    PYTHONPATH=src python -m repro_torch.benchmarks.robust_bench \\
        [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import M_CLIENTS, emit, make_task
from repro_torch.configs.base import FedConfig
from repro_torch.fed import FederatedSimulation

TARGET = 0.70
K_MEAN = 40
T, T_QUICK = 80, 40
HEADER = ("attack", "defense", "survived", "final_acc",
          f"rounds_to_{int(TARGET * 100)}", "quarantined")

# attack name -> FedConfig knobs (resolved by make_scenario)
ATTACK_KNOBS = {
    "clean": {},
    "nan_inject": {"scenario_rate": 0.3},
    "scale_attack": {"scenario_rate": 0.3, "scenario_magnitude": 25.0},
    "sign_flip": {"scenario_rate": 0.3},
    "garbage": {"scenario_rate": 0.3, "scenario_magnitude": 10.0},
}

DEFENSES = ("none", "clip", "median", "trimmed_mean", "krum")


def _one(attack: str, defense: str, rounds: int, device, *,
         nu_defense: bool = True, algorithm: str = "fedagrac") -> dict:
    m = M_CLIENTS
    task = make_task("lr", noniid=True, device=device)
    knobs = dict(ATTACK_KNOBS[attack])
    fed = FedConfig(algorithm=algorithm, n_clients=m, lr=task.lr,
                    k_mean=K_MEAN, k_var=0.3, k_mode="random",
                    calibration_rate=0.5, weights="data",
                    param_layout="flat",
                    scenario=attack if attack != "clean" else "baseline",
                    defense=defense, nu_defense=nu_defense,
                    quarantine_window=4 if defense != "none" else 0,
                    **knobs)
    sim = FederatedSimulation(task.loss_fn, task.params, fed, task.batcher,
                              eval_fn=task.eval_fn, device=task.device)
    try:
        hist = sim.run(rounds, eval_every=1)
        survived = bool(torch.isfinite(sim.state["params"]).all())
        # final = tail mean: the lr task oscillates round to round
        final = float(np.mean(hist.metric[-5:]))
        r = hist.rounds_to_target(TARGET)
        quar = float(np.sum(hist.quarantined)) if hist.quarantined else 0.0
    except FloatingPointError:
        # the eval guard fired: a non-finite metric at the host readback
        survived, final, r, quar = False, None, None, 0.0
    return {
        "algorithm": algorithm,
        "attack": attack,
        "defense": defense,
        "nu_defense": nu_defense,
        "survived": survived,
        "final_acc": final,
        "rounds_to_target": r,
        "reached_target": final is not None and final >= TARGET,
        "quarantined_rounds": quar,
    }


def run(quick: bool = False, device=None) -> tuple[list[tuple], dict]:
    """(rows, the JSON report)."""
    rounds = T_QUICK if quick else T
    attacks = (("clean", "nan_inject", "scale_attack", "sign_flip")
               if quick else tuple(ATTACK_KNOBS))
    defenses = ("none", "median", "trimmed_mean") if quick else DEFENSES

    rows, table = [], []
    for attack in attacks:
        for defense in defenses:
            r = _one(attack, defense, rounds, device)
            table.append(r)
            rt = r["rounds_to_target"]
            rows.append((
                attack, defense,
                "yes" if r["survived"] else "DIVERGED",
                f"{r['final_acc']:.4f}" if r["final_acc"] is not None
                else "-",
                rt if rt is not None else f">{rounds}",
                f"{r['quarantined_rounds']:.0f}",
            ))

    def final(attack, defense):
        v = next(r for r in table if r["attack"] == attack
                 and r["defense"] == defense)["final_acc"]
        return -1.0 if v is None else v

    # ν-defense ablation: the same attack and defense, model-only vs
    # model + ν
    ablation = [_one("sign_flip", "median", rounds, device,
                     nu_defense=nu_def) for nu_def in (False, True)]
    rescued = {a: {"undefended_final": final(a, "none"),
                   "best_defended_final": max(final(a, d) for d in defenses
                                              if d != "none")}
               for a in attacks if a != "clean"}
    survival = {
        "defended_gains_everywhere": all(
            v["best_defended_final"] >= v["undefended_final"] + 0.05
            for v in rescued.values()),
        "rescued": rescued,
        "nu_ablation": {"model_only_acc": ablation[0]["final_acc"],
                        "model_and_nu_acc": ablation[1]["final_acc"]},
    }
    report = {"table": table, "ablation": ablation, "survival": survival,
              "meta": {"quick": quick, "target": TARGET, "rounds": rounds,
                       "k_local_steps": K_MEAN,
                       "attack_knobs": ATTACK_KNOBS}}
    return rows, report


def main(quick: bool = False, device=None, out: Optional[str] = None
         ) -> None:
    rows, report = run(quick, device)
    emit(rows, HEADER)
    gains = report["survival"]["defended_gains_everywhere"]
    print(f"# defended gains everywhere: {'OK' if gains else 'NO'}")
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
