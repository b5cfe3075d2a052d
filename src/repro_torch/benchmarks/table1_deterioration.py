"""Paper Table 1: FedAvg deterioration matrix.

Rounds to reach the target accuracy under {neither, step-async, non-IID,
both} — async is the paper's bimodal regime (9 slow clients K=2, one fast
K=200).  Claim validated: each factor alone is mild; combined they
deteriorate sharply, worst for the convex model (objective inconsistency).

The twin of ``benchmarks/table1_deterioration.py``, on the port.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (bimodal_schedule, emit,
                                           make_task, rounds_to, run_sim)

T, T_QUICK = 60, 25
TARGET = {"lr": 0.78, "mlp": 0.78}
LABELS = {(False, False): "neither", (False, True): "step_async",
          (True, False): "non_iid", (True, True): "both"}


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    for kind in ("lr", "mlp"):
        for noniid in (False, True):
            for async_ in (False, True):
                task = make_task(kind, noniid=noniid, device=device)
                ks = bimodal_schedule() if async_ else None
                hist = run_sim(task, "fedavg", t, k_mean=20, k_var=0.0,
                               k_schedule=ks)
                rows.append(("table1", kind, LABELS[(noniid, async_)],
                             rounds_to(hist, TARGET[kind]),
                             round(hist.metric[-1], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "model", "setting",
                              "rounds_to_target", "final_acc"))
