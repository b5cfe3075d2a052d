"""Partial participation: FedaGrac with a sampled cohort of C = 8 out of
M = 256 clients vs full participation — the port's twin of
``examples/partial_participation.py``.

    PYTHONPATH=src python -m repro_torch.examples.partial_participation \\
        [--device cpu]

The quickstart task at population scale: 256 clients on the FedProx
synthetic(1,1) non-IID mixture.  Full participation runs every client every
round; a cohort round runs 8 — 32× less client work — with
Horvitz–Thompson renormalized weights keeping the aggregated direction an
unbiased estimate of the population update, and the server's calibration
state (ν, ν⁽ⁱ⁾) kept for the whole population across cohorts.  The
comparison is at EQUAL CLIENT WORK (40 full rounds vs 1280 cohort rounds =
10240 client·rounds each).

Where the reference draws batches on the device (``DeviceBatcher``), this
twin uses the host ``FederatedBatcher``: the port has no device batcher yet
(ROADMAP A5).  Cohorts are the port's own draws (numpy, keyed by (seed,
t)), not the reference's.  Runs on the card unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.data import FederatedBatcher, fedprox_synthetic
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models.simple import lr_accuracy, lr_init, lr_loss

M, C, WORK, TARGET = 256, 8, 40 * 256, 0.40
K_STEPS, BATCH = 4, 20
# int(jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)): the seed the
# reference example draws its numpy data from
DATA_SEED = 31327077


def task():
    """The 256-client FedProx synthetic(1,1) task, 50 samples a client."""
    return fedprox_synthetic(DATA_SEED, M, alpha=1.0, beta=1.0,
                             n_per_client=50)


def fed_config(algorithm: str = "fedagrac", **cohort_kw) -> FedConfig:
    return FedConfig(algorithm=algorithm, n_clients=M, lr=0.1,
                     calibration_rate=0.5, weights="data",
                     param_layout="flat", **cohort_kw)


def schedule() -> np.ndarray:
    return np.full((1, M), K_STEPS, np.int32)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    data, parts = task()
    x_eval, y_eval = data.x.to(device), data.y.to(device)

    runs = (("full  C=256", dict()),
            ("uniform C=8", dict(cohort_size=C, cohort_sampler="uniform")),
            ("roundrb C=8", dict(cohort_size=C,
                                 cohort_sampler="round_robin")))
    print(f"{'participation':14s} {'rounds':>7s} {'final acc':>10s} "
          f"{'client-work→{:.0%}'.format(TARGET):>16s}")
    out = {}
    for label, cohort_kw in runs:
        c = cohort_kw.get("cohort_size", M)
        t_rounds = WORK // c
        sim = FederatedSimulation(
            lr_loss, lr_init(torch.Generator(device=device), 60, 10),
            fed_config(**cohort_kw),
            FederatedBatcher(data, parts, batch_size=BATCH, device=device),
            k_schedule=schedule(), device=device,
            eval_fn=lambda p: float(lr_accuracy(p, {"x": x_eval,
                                                    "y": y_eval})))
        ev_every = t_rounds // 8
        hist = sim.run(t_rounds, eval_every=ev_every)
        r = hist.rounds_to_target(TARGET)
        work = f"{r * ev_every * c}" if r else f">{WORK}"
        out[label] = hist
        print(f"{label:14s} {t_rounds:>7d} {hist.metric[-1]:>10.4f} "
              f"{work:>16s}")
    print("\nA cohort round costs 32× less client work than a full one; "
          "the table sets them side by side at equal client work, with the "
          "calibration state spanning the whole population across cohorts "
          "(fed/population.py).")
    return out


if __name__ == "__main__":
    main()
