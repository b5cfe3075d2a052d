"""Paper Figure 3: global-orientation estimation strategies.

FedaGrac (fast→first, slow→avg) vs _avg (SCAFFOLD), _first, _reverse —
without asynchronism and in the high-noise bimodal regime (batch 5, one
client at K=500) where the strategies separate.  Claim validated: without
asynchronism the four coincide; with it the mixed rule is best and
all-first is worst (noisiest ν).

The twin of ``benchmarks/fig3_orientation.py``, on the port.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import (bimodal_schedule, emit,
                                           make_task, run_sim)

T, T_QUICK = 50, 15
SEEDS = 3
VARIANTS = ("fedagrac", "fedagrac_avg", "fedagrac_first", "fedagrac_reverse")


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    seeds = 1 if quick else SEEDS
    rows = []
    for async_ in (False, True):
        ks = bimodal_schedule(k_fast=500) if async_ else None
        for algo in VARIANTS:
            finals = []
            for seed in range(seeds):
                task = make_task("lr", noniid=True, seed=0,
                                 batch=5 if async_ else 20,
                                 batcher_seed=seed, device=device)
                hist = run_sim(task, algo, t, k_mean=20, k_schedule=ks,
                               lam=1.0, lr=0.01, seed=seed)
                finals.append(hist.metric[-1])
            rows.append(("fig3", "async" if async_ else "const", algo,
                         round(float(np.mean(finals)), 4),
                         round(float(np.std(finals)), 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "steps", "strategy", "final_acc",
                              "std"))
