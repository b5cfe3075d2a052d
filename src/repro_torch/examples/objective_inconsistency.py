"""Theorem 1 in pictures (ASCII): the FedAvg round map walks to a fixed
point that is NOT the optimum; FedaGrac walks to the optimum — the port's
twin of ``examples/objective_inconsistency.py``, on the port's flat round
over ``quad_loss``.

    PYTHONPATH=src python -m repro_torch.examples.objective_inconsistency \\
        [--device cpu]

8 clients with quadratics drawn from the integer the reference example
takes from its key (the same As, bs), K = [1, 1, 2, 2, 4, 4, 8, 20], lr
0.02, exact gradients, 200 rounds.  Runs on the card unless ``--device``
says otherwise.
"""
from __future__ import annotations

import argparse
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import flat, rounds, theory
from repro_torch.core.fedopt import get_algorithm
from repro_torch.data.synthetic import quadratic_clients
from repro_torch.device import resolve_device
from repro_torch.models.simple import quad_loss

M, D, LR, T = 8, 12, 0.02, 200
K = np.array([1, 1, 2, 2, 4, 4, 8, 20], np.int32)
W = np.full(M, 1.0 / M, np.float32)
# int(jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)): the seed the
# reference example draws its quadratics from
QUAD_SEED = 31327077


def trajectory(algo_name: str, lam: float, As: np.ndarray, bs: np.ndarray,
               device: Union[str, torch.device], t: int = T) -> np.ndarray:
    """(t, D) server iterates of ``t`` flat rounds on the quadratics."""
    fed = FedConfig(algorithm=algo_name, n_clients=M, lr=LR,
                    calibration_rate=lam, param_layout="flat")
    algo = get_algorithm(algo_name, fed)
    k_max = int(K.max())
    params = {"x": torch.zeros(D, device=device)}
    spec = flat.make_flat_spec(params)
    state = rounds.init_state(flat.ravel(spec, params), M, algo)
    fn = flat.make_flat_round(spec, quad_loss, algo, lr=LR, k_max=k_max)
    A = torch.from_numpy(As).to(device)
    b = torch.from_numpy(bs).to(device)
    batches = {"A": A[:, None].expand(M, k_max, D, D),
               "b": b[:, None].expand(M, k_max, D),
               "c0": torch.zeros(M, k_max, device=device)}
    ks = torch.from_numpy(K).to(device)
    w = torch.from_numpy(W).to(device)
    xs = []
    for _ in range(t):
        state, _ = fn(state, batches, ks, w)
        xs.append(state["params"][:D].clone())
    return torch.stack(xs).cpu().numpy()


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    As, bs = quadratic_clients(QUAD_SEED, M, D, hetero=1.5)
    x_star = theory.global_optimum(As, bs, W)
    fp = theory.fedavg_fixed_point(As, bs, W, K, LR)
    print(f"Theorem-1 RHS (inconsistency bound): "
          f"{theory.objective_inconsistency_rhs(As, bs, W, K, x_star):.3f}")
    print(f"closed-form FedAvg fixed point is "
          f"{np.linalg.norm(fp - x_star):.3f} away from x*\n")
    print(f"{'round':>6} {'FedAvg → x*':>14} {'FedaGrac → x*':>14}")
    tr_avg = trajectory("fedavg", 0.0, As, bs, device)
    tr_grac = trajectory("fedagrac", 1.0, As, bs, device)
    d0 = max(float(np.linalg.norm(tr_avg[0] - x_star)), 1e-9)
    for t in (0, 4, 9, 24, 49, 99, 199):
        da = np.linalg.norm(tr_avg[t] - x_star)
        dg = np.linalg.norm(tr_grac[t] - x_star)
        print(f"{t + 1:>6} {da:>14.6f} {dg:>14.6f}   "
              f"{'#' * int(20 * da / d0)}")
    out = {"fedavg_to_fixed_point": float(np.linalg.norm(tr_avg[-1] - fp)),
           "fedagrac_to_x_star": float(np.linalg.norm(tr_grac[-1] - x_star)),
           "fixed_point_to_x_star": float(np.linalg.norm(fp - x_star))}
    print(f"\nFedAvg stalled at its fixed point "
          f"(dist {out['fedavg_to_fixed_point']:.2e} from closed form); "
          f"FedaGrac reached x* (dist {out['fedagrac_to_x_star']:.2e}).")
    return out


if __name__ == "__main__":
    main()
