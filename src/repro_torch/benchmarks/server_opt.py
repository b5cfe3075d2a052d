"""Beyond-paper: FedOpt server optimizers × client calibration.

Reddi et al. (2021) server optimizers applied to the round pseudo-gradient
compose freely with the client-side rules here.  Question examined: does a
server optimizer (FedAvgM / FedAdam) substitute for calibration under
step asynchronism, or do they address different failure modes?

The twin of ``benchmarks/server_opt.py``, on the port.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (bimodal_schedule, emit,
                                           make_task, rounds_to)
from repro_torch.configs.base import FedConfig
from repro_torch.fed import FederatedSimulation

T, T_QUICK = 40, 15
COMBOS = (
    ("fedavg", "sgd", 1.0),
    ("fedavg", "momentum", 1.0),
    ("fedavg", "adam", 0.05),
    ("fedagrac", "sgd", 1.0),
    ("fedagrac", "adam", 0.05),
)


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    ks = bimodal_schedule()
    for client_algo, server, slr in COMBOS:
        task = make_task("lr", noniid=True, device=device)
        fed = FedConfig(algorithm=client_algo, n_clients=task.batcher.m,
                        lr=task.lr, calibration_rate=1.0, weights="data",
                        server_opt=server, server_lr=slr,
                        param_layout="flat")
        sim = FederatedSimulation(task.loss_fn, task.params, fed,
                                  task.batcher, eval_fn=task.eval_fn,
                                  k_schedule=ks, device=task.device)
        hist = sim.run(t)
        rows.append(("server_opt", client_algo, server, slr,
                     rounds_to(hist, 0.77), round(hist.metric[-1], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "client", "server", "server_lr",
                              "rounds_to_077", "final_acc"))
