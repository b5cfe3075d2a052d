"""Paper Figure 4: η × λ grid.

Claim validated: under convex objectives λ=1 is robust across learning
rates and pairs best with a SMALL η (the strongly-convex theory sets λ=1);
over-calibration shows as the large-η/large-λ corner collapsing.

The twin of ``benchmarks/fig4_grid.py``, on the port.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import emit, make_task, run_sim

ETAS = (0.005, 0.02, 0.05)
ETAS_QUICK = (0.02,)
LAMBDAS = (0.05, 0.5, 1.0)
T, T_QUICK = 40, 15


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    for kind in ("lr", "mlp"):
        for eta in (ETAS_QUICK if quick else ETAS):
            for lam in LAMBDAS:
                task = make_task(kind, noniid=True, device=device)
                hist = run_sim(task, "fedagrac", t, k_mean=40, k_var=400.0,
                               lam=lam, lr=eta)
                rows.append(("fig4", kind, eta, lam,
                             round(hist.metric[-1], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "model", "eta", "lambda",
                              "final_acc"))
