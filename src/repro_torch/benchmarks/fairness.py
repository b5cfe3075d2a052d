"""Beyond-paper: per-client fairness under step asynchronism.

FL fairness reporting (q-FFL convention): worst-client accuracy and the
across-client std of the final model.  Question examined: does FedaGrac's
calibration — which prevents the fast client from dragging the model
toward its local optimum — also improve the WORST client?

The twin of ``benchmarks/fairness.py``, on the port: each client's eval
rows move to the device once.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import bimodal_schedule, emit, make_task
from repro_torch.configs.base import FedConfig
from repro_torch.fed import FederatedSimulation
from repro_torch.models.simple import lr_accuracy

T, T_QUICK = 40, 15
ALGOS = ("fedavg", "fednova", "fedagrac")


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    ks = bimodal_schedule()
    for algo in ALGOS:
        task = make_task("lr", noniid=True, device=device)
        data = task.batcher.data
        client_sets = [{"x": data.x[rows_i].to(task.device),
                        "y": data.y[rows_i].to(task.device)}
                       for rows_i in map(torch.from_numpy,
                                         task.batcher.parts)]

        def per_client(p):
            return [float(lr_accuracy(p, b)) for b in client_sets]

        fed = FedConfig(algorithm=algo, n_clients=task.batcher.m,
                        lr=task.lr, calibration_rate=1.0, weights="data",
                        param_layout="flat")
        sim = FederatedSimulation(task.loss_fn, task.params, fed,
                                  task.batcher, eval_fn=task.eval_fn,
                                  eval_per_client=per_client,
                                  k_schedule=ks, device=task.device)
        hist = sim.run(t, eval_every=t)          # evaluate final model only
        f = hist.fairness()
        rows.append(("fairness", algo, round(hist.metric[-1], 4),
                     round(f["worst"], 4), round(f["best"], 4),
                     round(f["std"], 4)))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "algorithm", "global_acc",
                              "worst_client", "best_client", "client_std"))
