"""Failure scenarios: mid-round dropout with partial-work recovery — the
port's twin of ``examples/failure_scenarios.py``, a dropout-rate sweep
over FedAvg, FedNova and FedaGrac.

    PYTHONPATH=src python -m repro_torch.examples.failure_scenarios \\
        [--device cpu]

The quickstart task under faults: M = 16 clients on the FedProx
synthetic(1,1) non-IID mixture (the reference's data: numpy seed
``DATA_SEED``), heterogeneous local steps K_i ~ N(8, 3²), and the
``dropout`` scenario aborting each (round, client) independently with
probability p.  An aborted client delivers the k′-step prefix it completed,
aggregated at its k′ step count.  Batches come from ``DeviceBatcher`` as in
the reference: the reference's own keyed indices, drawn on the device in
each chunk, and the dropout draws are the reference's keyed ones, so the
table's rows are the reference's (``reference_quick.json`` carries them to
the card).  Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.data import DeviceBatcher, fedprox_synthetic
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models.simple import lr_accuracy, lr_loss

M, T_ROUNDS = 16, 10
RATES = (0.0, 0.3, 0.6)
ALGORITHMS = ("fedavg", "fednova", "fedagrac")
# int(jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)): the numpy seed the
# reference example's fedprox_synthetic draws from
DATA_SEED = 31327077


def fed_config(algorithm: str, rate: float) -> FedConfig:
    return FedConfig(algorithm=algorithm, n_clients=M, lr=0.05,
                     calibration_rate=0.5, weights="data", k_mean=8,
                     k_var=3.0, k_mode="random",
                     scenario="baseline" if rate == 0 else "dropout",
                     dropout_rate=rate, param_layout="flat")


def run(device, algorithms=ALGORITHMS, rates=RATES) -> list[list[str]]:
    """The printed table's rows: the algorithm, the final accuracy at each
    rate (``%.4f``) and the dropped fraction at the last rate (``%.3f``),
    each cell a string."""
    device = resolve_device(device)
    data, parts = fedprox_synthetic(DATA_SEED, M, alpha=1.0, beta=1.0,
                                    n_per_client=50)
    eval_set = {"x": data.x.to(device), "y": data.y.to(device)}
    rows = []
    for algorithm in algorithms:
        accs, dropped = [], 0.0
        for rate in rates:
            params = {"w": torch.zeros(60, 10, device=device),
                      "b": torch.zeros(10, device=device)}
            sim = FederatedSimulation(
                lr_loss, params, fed_config(algorithm, rate),
                DeviceBatcher(data, parts, batch_size=20, device=device),
                eval_fn=lambda p: float(lr_accuracy(p, eval_set)),
                device=device)
            hist = sim.run(T_ROUNDS, eval_every=T_ROUNDS)
            accs.append(hist.metric[-1])
            dropped = float(np.mean(hist.dropped)) if hist.dropped else 0.0
        rows.append([algorithm] + [f"{a:.4f}" for a in accs]
                    + [f"{dropped:.3f}"])
    return rows


def main(argv: Optional[list] = None) -> list[list[str]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    rows = run(args.device)
    print(f"{'algorithm':10s} " + " ".join(
        f"{'p=' + format(p, '.1f'):>10s}" for p in RATES)
        + f" {'dropped':>8s}")
    for row in rows:
        print(f"{row[0]:10s} " + " ".join(f"{a:>10s}" for a in row[1:-1])
              + f" {row[-1]:>8s}")
    print("\nDrop rates are per-(round, client) draws, pure in (seed, "
          "round, client): re-running any round — alone, resumed, or in a "
          "different chunk split — aborts the same clients at the same step "
          "counts (fed/scenarios.py).")
    return rows


if __name__ == "__main__":
    main()
