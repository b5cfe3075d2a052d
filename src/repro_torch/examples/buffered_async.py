"""Buffered semi-asynchronous FedaGrac, one config switch away from sync —
the port's twin of ``examples/buffered_async.py``.

    PYTHONPATH=src python -m repro_torch.examples.buffered_async \\
        [--rounds T] [--device cpu]

The same 10-client non-IID task as quickstart.py, on a heterogeneous
*hardware* fleet (lognormal step rates): the synchronous engine pays the
straggler every round, while the buffered engine (``FedConfig.
buffer_size``) updates on the first M' reports and discounts stale ones
(``FedConfig.staleness``).  Both engines run the same client-update and
orientation stages (core/stages.py): with buffer_size = M and equal speeds
the async engine computes the synchronous round, shown below to float32
rounding.  Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.data import FederatedBatcher, fedprox_synthetic
from repro_torch.device import resolve_device
from repro_torch.fed import BufferedAsyncSimulation, FederatedSimulation
from repro_torch.fed.clock import make_clock
from repro_torch.models.simple import lr_accuracy, lr_init, lr_loss

M, T = 10, 25
# int(jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1)): the seed the
# reference's examples draw their numpy data from
DATA_SEED = 31327077


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=T)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    t = args.rounds
    device = resolve_device(args.device)
    data, parts = fedprox_synthetic(DATA_SEED, M, alpha=1.0, beta=1.0)
    x_eval, y_eval = data.x.to(device), data.y.to(device)

    def eval_fn(p):
        return float(lr_accuracy(p, {"x": x_eval, "y": y_eval}))

    def params():
        return lr_init(torch.Generator(device=device), 60, 10)

    def batcher():
        return FederatedBatcher(data, parts, batch_size=20, device=device)

    ks = np.full((t * M + 1, M), 40, np.int32)
    fed = FedConfig(algorithm="fedagrac", n_clients=M, lr=0.02,
                    calibration_rate=1.0, weights="data",
                    param_layout="flat")

    # -- 1. buffer = M + equal speeds computes the synchronous round -------
    sync = FederatedSimulation(lr_loss, params(), fed, batcher(),
                               eval_fn=eval_fn, k_schedule=ks, device=device)
    h_sync = sync.run(t)
    full = BufferedAsyncSimulation(
        lr_loss, params(),
        dataclasses.replace(fed, buffer_size=M, speed_dist="fixed"),
        batcher(), eval_fn=eval_fn, k_schedule=ks, device=device)
    h_full = full.run(t)
    drift = float((sync.state["params"] - full.state["params"]).abs().max())
    print(f"buffer=M vs synchronous: max |Δparam| = {drift:.2e}  "
          f"acc {h_sync.metric[-1]:.4f} vs {h_full.metric[-1]:.4f}")

    # -- 2. heterogeneous fleet: straggler-bound sync vs buffered async ----
    clock = make_clock(M, dist="lognormal", sigma=1.0, seed=7)
    sync_s = clock.round_time(ks[0]) * t            # straggler every round
    # λ halved under staleness: full-strength calibration against a stale
    # ν misorients clients
    buf = BufferedAsyncSimulation(
        lr_loss, params(),
        dataclasses.replace(fed, buffer_size=4 * M // 5, staleness="hinge",
                            staleness_a=0.5, staleness_b=2,
                            calibration_rate=0.5),
        batcher(), eval_fn=eval_fn, k_schedule=ks, clock=clock,
        device=device)
    h_buf = buf.run(3 * t)         # straggler idle time buys extra updates
    print(f"\n{'engine':24s} {'server upd':>10s} {'sim seconds':>12s} "
          f"{'final acc':>10s} {'mean stale':>10s}")
    print(f"{'synchronous':24s} {t:>10d} {sync_s:>12.1f} "
          f"{h_sync.metric[-1]:>10.4f} {0.0:>10.1f}")
    print(f"{'buffered (0.8M, hinge)':24s} {len(h_buf.loss):>10d} "
          f"{h_buf.sim_time[-1]:>12.1f} {h_buf.metric[-1]:>10.4f} "
          f"{np.mean(h_buf.staleness):>10.1f}")
    print("\nThe buffered engine never waits for the straggler: within the "
          "synchronous run's wall-clock it fits 3x the server updates "
          "(benchmarks/table_async.py for the full comparison).")
    return {"sync": h_sync, "full": h_full, "buffered": h_buf,
            "drift": drift}


if __name__ == "__main__":
    main()
