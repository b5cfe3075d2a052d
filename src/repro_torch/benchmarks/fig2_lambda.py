"""Paper Figure 2: calibration-rate sensitivity (non-convex track).

λ sweep under constant and asynchronous local steps + the "Increase"
schedule (0.1 → 0.5 → 1.0).  Claim validated: small λ ≈ FedAvg, large λ
over-calibrates (accuracy collapses under asynchronism); the increasing
schedule matches the best constants.

The twin of ``benchmarks/fig2_lambda.py``, on the port; the schedule is
the port's ``optim.lambda_increase``, whose float32 λ values are the
reference's.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import emit, make_task, run_sim
from repro_torch.optim import lambda_increase

T, T_QUICK = 40, 15
LAMBDAS = (0.0, 0.05, 0.1, 0.5, 1.0, 2.0)
LAMBDAS_QUICK = (0.0, 0.5, 2.0)


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    for async_ in (False, True):
        k_var = 400.0 if async_ else 0.0
        steps = "async" if async_ else "const"
        for lam in (LAMBDAS_QUICK if quick else LAMBDAS):
            task = make_task("mlp", noniid=True, device=device)
            hist = run_sim(task, "fedagrac", t, k_mean=40, k_var=k_var,
                           lam=lam)
            rows.append(("fig2", steps, lam, round(hist.metric[-1], 4)))
        task = make_task("mlp", noniid=True, device=device)
        hist = run_sim(task, "fedagrac", t, k_mean=40, k_var=k_var, lam=0.1,
                       lam_schedule=lambda_increase(
                           (t // 4, t // 2), (0.1, 0.5, 1.0)))
        rows.append(("fig2", steps, "increase", round(hist.metric[-1], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "steps", "lambda", "final_acc"))
