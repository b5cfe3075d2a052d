"""Paper Table 2: fast-node utilization.

One powerful client (K_fast = scale × K_slow) + 9 slow clients, non-IID.
Claim validated: FedAvg/FedNova cannot convert the fast node's extra local
work into speed (rounds-to-target stays flat or worsens); FedaGrac
accelerates with it — i.e. full utilization of the powerful device.

The twin of ``benchmarks/table2_utilization.py``, on the port.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (bimodal_schedule, emit,
                                           make_task, rounds_to, run_sim)

T, T_QUICK = 50, 25
TARGET = 0.77
K_SLOW = 2
SCALES, SCALES_QUICK = (1, 10, 50, 100), (1, 100)
ALGOS = ("fednova", "fedagrac", "fedavg")


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    for scale in (SCALES_QUICK if quick else SCALES):
        ks = bimodal_schedule(k_slow=K_SLOW, k_fast=K_SLOW * scale)
        for algo in ALGOS:
            task = make_task("lr", noniid=True, device=device)
            hist = run_sim(task, algo, t, k_schedule=ks, lam=1.0)
            rows.append(("table2", algo, f"fast_x{scale}",
                         rounds_to(hist, TARGET),
                         round(hist.metric[-1], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "algorithm", "fast_node_scale",
                              "rounds_to_target", "final_acc"))
