"""Theorem 1 / Theorem 3 closed-form validation on quadratics.

Reports, per heterogeneity level: the distance of the *simulated* FedAvg
round map's limit from (a) the closed-form fixed point (should be ≈0) and
(b) the global optimum (the objective-inconsistency gap), the Theorem-1
RHS bound, and FedaGrac's terminal distance (should be ≈0, Theorem 3).

The twin of ``benchmarks/thm1_quadratic.py``: the reference's tree round
becomes the port's flat round on ``quad_loss``
(``examples.objective_inconsistency.trajectory``), over the quadratics the
reference draws from ``PRNGKey(0)`` (numpy seed ``QUAD_SEED``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import emit
from repro_torch.core import theory
from repro_torch.data.synthetic import quadratic_clients
from repro_torch.device import resolve_device
from repro_torch.examples.objective_inconsistency import (D, K, LR, M, W,
                                                          trajectory)

# int(jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)): the numpy seed of
# the reference's quadratic_clients(PRNGKey(0), ...)
QUAD_SEED = 31327077
T, T_QUICK = 400, 150
HETERO = (0.5, 1.5, 3.0)
ALGORITHMS = (("fedavg", 0.0), ("fedagrac", 1.0))


def run(quick: bool = False, device=None) -> list[tuple]:
    device = resolve_device(device)
    t = T_QUICK if quick else T
    rows = []
    for hetero in HETERO:
        As, bs = quadratic_clients(QUAD_SEED, M, D, hetero=hetero)
        x_star = theory.global_optimum(As, bs, W)
        fp = theory.fedavg_fixed_point(As, bs, W, K, LR)
        x_avg, x_grac = (trajectory(name, lam, As, bs, device, t)[-1]
                         for name, lam in ALGORITHMS)
        rhs = theory.objective_inconsistency_rhs(As, bs, W, K, x_star)
        rows.append(("thm1", hetero,
                     round(float(np.linalg.norm(x_avg - fp)), 6),
                     round(float(np.linalg.norm(x_avg - x_star)), 4),
                     round(float(theory.suboptimality(As, bs, W, x_avg,
                                                      x_star)), 4),
                     round(rhs, 4),
                     round(float(np.linalg.norm(x_grac - x_star)), 6)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "hetero", "fedavg_to_fixed_point",
                              "fedavg_to_opt", "fedavg_subopt", "thm1_rhs",
                              "fedagrac_to_opt"))
