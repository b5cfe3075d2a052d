"""Shared task builders for the paper-experiment twins
(``benchmarks/common.py`` counterpart).

The paper's datasets (Fashion-MNIST / CIFAR-10 / a9a) are replaced by the
canonical FedProx ``synthetic(α, β)`` task — per-client softmax models and
feature shift, the standard benchmark where client drift measurably hurts.
"lr" keeps the paper's convex track, "mlp" the non-convex track.  Each
module's docstring states the paper claim it validates.

The twins train on the reference's own data and weights, so a row of one
package lines up with a row of the other:

* the reference's data seed 0 is the key ``PRNGKey(0)``, from which its
  ``fedprox_synthetic`` draws the numpy seed 31327077; the port's takes
  that integer (``DATA_SEEDS``).  Any other seed needs its numpy
  ``data_seed`` given;
* partitions, the batcher's draws and the K schedule come from numpy in
  both packages, from the same integers;
* the lr model starts from zeros, the mlp from the reference's
  ``mlp_init(PRNGKey(0), 60, 64, 10)``, committed beside this module as
  ``mlp_init_key0.npz`` (4554 floats).

Every task runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import FedConfig
from repro_torch.data import (FederatedBatcher, fedprox_synthetic,
                              iid_partition, shard_partition)
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models.simple import (lr_accuracy, lr_init, lr_loss,
                                       mlp_accuracy, mlp_loss)

M_CLIENTS = 10
D, N_CLASSES = 60, 10
# calibrated on this task: FedAvg needs ~26-46 rounds to 80% under bimodal
# step asynchronism; calibrated methods need ~5-8 (see EXPERIMENTS.md)
LR_CONVEX = 0.02
LR_NONCONVEX = 0.03
# int(jax.random.randint(PRNGKey(seed), (), 0, 2**31 - 1)): the numpy seed
# the reference's fedprox_synthetic draws its data from, by data seed
DATA_SEEDS = {0: 31327077}
# the reference's mlp_init(PRNGKey(0), D, 64, N_CLASSES)
MLP_INIT_KEY0 = Path(__file__).with_name("mlp_init_key0.npz")

Device = Union[str, torch.device, None]


@dataclasses.dataclass
class Task:
    name: str
    loss_fn: Callable
    params: dict
    batcher: FederatedBatcher
    eval_fn: Callable
    lr: float
    device: torch.device


def _numpy_data_seed(seed: int, data_seed: Optional[int]) -> int:
    if data_seed is not None:
        return data_seed
    if seed not in DATA_SEEDS:
        raise ValueError(
            f"the numpy seed behind the reference's data seed {seed} is not "
            f"known here (only {sorted(DATA_SEEDS)}); pass data_seed")
    return DATA_SEEDS[seed]


def _mlp_params(seed: int, device: torch.device) -> dict:
    """The reference's initial mlp, ``mlp_init(PRNGKey(seed), ...)``: only
    seed 0's is carried across."""
    if seed != 0:
        raise ValueError(f"the reference's initial mlp weights of seed "
                         f"{seed} are not carried across (only seed 0's)")
    with np.load(MLP_INIT_KEY0) as f:
        return convert.params_from_numpy({k: f[k] for k in f.files}, device)


def _task(kind: str, data, parts, batcher_seed: int, batch: int, seed: int,
          device: torch.device) -> Task:
    batcher = FederatedBatcher(data, parts, batch_size=batch,
                               seed=batcher_seed, device=device)
    # the eval set moves to the device once, not at each eval
    eval_set = {"x": data.x.to(device), "y": data.y.to(device)}
    if kind == "lr":
        params = lr_init(torch.Generator(device=device), D, N_CLASSES)
        return Task("lr", lr_loss, params, batcher,
                    lambda p: float(lr_accuracy(p, eval_set)), LR_CONVEX,
                    device)
    return Task("mlp", mlp_loss, _mlp_params(seed, device), batcher,
                lambda p: float(mlp_accuracy(p, eval_set)), LR_NONCONVEX,
                device)


def make_task(kind: str, *, noniid: bool, seed: int = 0,
              m: int = M_CLIENTS, batch: int = 20,
              batcher_seed: Optional[int] = None,
              sampler: str = "host", data_seed: Optional[int] = None,
              device: Device = None) -> Task:
    """kind: "lr" (convex) or "mlp" (non-convex).

    The GLOBAL dataset is always the same synthetic(1,1) mixture;
    ``noniid`` only switches the PARTITION (client-generated shards vs an
    IID shuffle) — the correct Table-1 contrast.  ``sampler`` "host" is the
    numpy per-round gather; the reference's "device" sampler
    (``DeviceBatcher``) waits for ROADMAP A5."""
    if sampler != "host":
        raise NotImplementedError(
            f"sampler={sampler!r}: the PyTorch port has the host batcher "
            f"only; the device batcher is ROADMAP A5")
    device = resolve_device(device)
    data, parts = fedprox_synthetic(_numpy_data_seed(seed, data_seed), m,
                                    alpha=1.0, beta=1.0, d=D,
                                    n_classes=N_CLASSES)
    if not noniid:
        parts = iid_partition(len(data), m, seed=seed)
    return _task(kind, data, parts,
                 seed if batcher_seed is None else batcher_seed, batch,
                 seed, device)


def make_task_dp2(kind: str, seed: int = 0, m: int = M_CLIENTS,
                  data_seed: Optional[int] = None,
                  device: Device = None) -> Task:
    """DP2 variant: same synthetic features, clients re-partitioned by
    label shards (5 of 10 classes per client) — label skew on top of the
    model/feature skew."""
    device = resolve_device(device)
    data, _ = fedprox_synthetic(_numpy_data_seed(seed, data_seed), m,
                                alpha=1.0, beta=1.0, d=D,
                                n_classes=N_CLASSES)
    parts = shard_partition(data.y.numpy(), m, classes_per_client=5,
                            seed=seed)
    return _task(kind, data, parts, seed, 20, seed, device)


def bimodal_schedule(m: int = M_CLIENTS, k_slow: int = 2,
                     k_fast: int = 200) -> np.ndarray:
    """The paper's Raspberry-Pi + GPU regime: m−1 slow clients, one fast."""
    ks = np.full((1, m), k_slow, np.int32)
    ks[0, -1] = k_fast
    return ks


def run_sim(task: Task, algorithm: str, t_rounds: int, *,
            k_mean: int = 40, k_var: float = 0.0, k_mode: str = "fixed",
            lam: float = 1.0, lr: float | None = None, seed: int = 0,
            k_schedule=None, lam_schedule=None, eval_every: int = 1,
            chunk_rounds=None):
    fed = FedConfig(algorithm=algorithm, n_clients=task.batcher.m,
                    k_mean=k_mean, k_var=k_var, k_mode=k_mode,
                    lr=lr if lr is not None else task.lr,
                    calibration_rate=lam, weights="data", seed=seed,
                    param_layout="flat")
    sim = FederatedSimulation(task.loss_fn, task.params, fed, task.batcher,
                              eval_fn=task.eval_fn, k_schedule=k_schedule,
                              lam_schedule=lam_schedule, device=task.device)
    return sim.run(t_rounds, eval_every=eval_every,
                   chunk_rounds=chunk_rounds)


def rounds_to(hist, target: float):
    r = hist.rounds_to_target(target)
    return r if r is not None else f">{len(hist.metric)}"


def emit(rows: list[tuple], header: tuple) -> None:
    print(",".join(header))
    for row in rows:
        print(",".join(str(x) for x in row))
