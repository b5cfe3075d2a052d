"""Paper Figure 5: accuracy-vs-round curves under different Gaussian means
(fixed relative variance).  Claim validated: FedaGrac reaches the target in
fewer rounds; the convex track exposes objective inconsistency —
FedAvg/FedNova/FedProx plateau below FedaGrac/SCAFFOLD.

The twin of ``benchmarks/fig5_curves.py``, on the port.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import emit, make_task, run_sim

T, T_QUICK = 40, 15
ALGOS = ("fedagrac", "fedavg", "fednova", "scaffold", "fedprox")
LAM = {"fedagrac": 0.5}
MEANS, MEANS_QUICK = (10, 40), (40,)


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    for kind in ("lr", "mlp"):
        for mean in (MEANS_QUICK if quick else MEANS):
            for algo in ALGOS:
                task = make_task(kind, noniid=True, device=device)
                lam = 1.0 if kind == "lr" else LAM.get(algo, 1.0)
                hist = run_sim(task, algo, t, k_mean=mean,
                               k_var=float(mean ** 2) / 4, lam=lam)
                pts = hist.metric[:: max(t // 5, 1)] + [hist.metric[-1]]
                rows.append(("fig5", kind, mean, algo,
                             ";".join(f"{p:.3f}" for p in pts)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "model", "k_mean", "algorithm",
                              "acc_curve"))
