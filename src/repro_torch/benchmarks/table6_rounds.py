"""Paper Table 6: rounds-to-target across algorithms × K-variance × mode.

Five algorithms under Gaussian K_i ~ N(40, V), V ∈ {0, 100, 1600},
fixed/random modes, DP1 (Dirichlet-like model skew) and DP2 (label
shards).  Claim validated: calibrated methods (FedaGrac / SCAFFOLD) hold
their round count as variance grows; FedAvg/FedNova lose the most.

The twin of ``benchmarks/table6_rounds.py``, on the port.  Every round
runs the schedule's k_max local steps (the "random" rows' k_max is the
largest draw over the schedule's rounds, ~216 at V = 1600), masked per
client, as the reference's do.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (emit, make_task, make_task_dp2,
                                           rounds_to, run_sim)

T, T_QUICK = 50, 20
TARGET = {"dp1": 0.80, "dp2": 0.80}
ALGOS = ("fedagrac", "fedavg", "fednova", "scaffold", "fedprox")
LAM = {"fedagrac": 0.5}
VARIANCES = ((0.0, "fixed"), (100.0, "fixed"), (100.0, "random"),
             (1600.0, "fixed"), (1600.0, "random"))
VARIANCES_QUICK = ((0.0, "fixed"), (1600.0, "fixed"))


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    for dp, mk in (("dp1", lambda: make_task("mlp", noniid=True,
                                             device=device)),
                   ("dp2", lambda: make_task_dp2("mlp", device=device))):
        for var, mode in (VARIANCES_QUICK if quick else VARIANCES):
            for algo in ALGOS:
                hist = run_sim(mk(), algo, t, k_mean=40, k_var=var,
                               k_mode=mode, lam=LAM.get(algo, 1.0))
                rows.append(("table6", dp, f"V={var:g}", mode, algo,
                             rounds_to(hist, TARGET[dp]),
                             round(hist.metric[-1], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "partition", "variance", "mode",
                              "algorithm", "rounds_to_target", "final_acc"))
