"""Where a round of the main path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.roofline.round_profile

Builds the paper's non-convex task at full width (mlp 60-64-10, batch 20,
FedProx synthetic(1,1), 10 clients, the bimodal schedule: nine clients at
K = 2, one at K = 200; lr 0.03, λ = 1), runs one round warm, then profiles
one more round per algorithm with ``torch.profiler`` and prints one JSON
line each: the round's host wall time, the device's busy time (the union
of kernel intervals) and idle share, kernel launches per local step, the
calibrated-update kernels' device time, and the kernels by device time.

    PYTHONPATH=src python -m repro_torch.roofline.round_profile \
        --population 100000

profiles a chunk of cohort rounds instead: FedaGrac on a population of
that many clients, a uniform cohort of 8 a round, K 4, batch 16, the same
mlp over Gaussian-blob data at 2 samples a client (the population bench's
setting, chip_smoke.py phase 11), one warm chunk of 12 rounds, then one
profiled chunk; the line reports per round.  With ``--buffered`` the
same setting runs on the buffered-async engine (8 clients in flight, a
buffer of 8, hinge staleness, a lognormal σ = 1 fleet) and the line
reports per update.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import FedConfig
from repro_torch.core import flat, rounds
from repro_torch.core.fedopt import get_algorithm
from repro_torch.data import FederatedBatcher, fedprox_synthetic
from repro_torch.models.simple import mlp_init, mlp_loss

K_MAX = 200


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def profile_round(algorithm: str, top: int = 8) -> dict:
    data, parts = fedprox_synthetic(0, 10, alpha=1.0, beta=1.0)
    params = mlp_init(torch.Generator().manual_seed(0), 60, 64, 10)
    ks = np.full(10, 2, np.int32)
    ks[-1] = K_MAX
    fed = FedConfig(algorithm=algorithm, n_clients=10, lr=0.03,
                    calibration_rate=1.0, weights="data",
                    param_layout="flat")
    algo = get_algorithm(algorithm, fed)
    spec = flat.make_flat_spec(params)
    round_fn = flat.make_flat_round(spec, mlp_loss, algo, lr=fed.lr,
                                    k_max=K_MAX)
    state = rounds.init_state(flat.ravel(spec, params).cuda(), 10, algo)
    batcher = FederatedBatcher(data, parts, batch_size=20, device="cuda")
    weights = batcher.weights
    k_t = torch.as_tensor(ks, device="cuda")
    batches = [batcher.round_batches(t, K_MAX) for t in range(2)]
    state, _ = round_fn(state, batches[0], k_t, weights, 1.0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        round_fn(state, batches[1], k_t, weights, 1.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    return {"algorithm": algorithm,
            **_breakdown(prof, wall_us, K_MAX, 1, top)}


def _breakdown(prof, wall_us: float, steps: int, rounds_: int,
               top: int) -> dict:
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    return {"device": torch.cuda.get_device_name(0),
            "round_wall_ms": wall_us / 1e3 / rounds_,
            "device_busy_ms": busy / 1e3 / rounds_,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches_per_round": len(kernels) / rounds_,
            "launches_per_local_step": len(kernels) / steps,
            "calibrated_update_ms": sum(
                t for name, (_, t) in by_name.items()
                if "calibrated_update" in name) / 1e3 / rounds_,
            "top_kernels": [
                {"name": name[:80], "launches": n, "ms": t / 1e3}
                for name, (n, t) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][1])[:top]]}


# benchmarks/population_bench.py's setting, on the mlp
POPULATION = {"cohort": 8, "k": 4, "batch": 16, "d": 60, "classes": 10,
              "n_data": 4096, "lr": 0.05, "lam": 0.5, "sampler": "uniform",
              "chunk": 12}


def _population_parts(m: int, pop: dict, device: str,
                      sampler: str = "host"):
    """(batcher, initial mlp, K schedule) of the population setting:
    Gaussian blobs at 2 samples a client (at least ``n_data``), IID parts,
    one K row (the default schedule would be (10k, M)); ``sampler`` "host"
    (``FederatedBatcher``) or "device" (``DeviceBatcher``)."""
    from repro_torch.data import (DeviceBatcher, gaussian_classification,
                                  iid_partition)
    data = gaussian_classification(torch.Generator().manual_seed(0),
                                   max(pop["n_data"], 2 * m), d=pop["d"],
                                   n_classes=pop["classes"])
    batcher_cls = {"host": FederatedBatcher,
                   "device": DeviceBatcher}[sampler]
    batcher = batcher_cls(data, iid_partition(len(data), m, seed=0),
                          batch_size=pop["batch"], seed=0, device=device)
    params = mlp_init(torch.Generator().manual_seed(0), pop["d"], 64,
                      pop["classes"])
    return batcher, params, np.full((1, m), pop["k"], np.int32)


def population_simulation(m: int, pop: dict = POPULATION,
                          device: str = "cuda", sampler: str = "host",
                          **fed_kw):
    """FedaGrac on ``m`` clients, a cohort of ``pop["cohort"]`` a round,
    on the mlp ``d``-64-``classes`` over Gaussian blobs at 2 samples a
    client (at least ``n_data``), IID parts, one K row, on the flat layout;
    ``fed_kw`` adds or replaces config fields (a compressor, the tree
    layout), ``sampler`` picks the batcher."""
    from repro_torch.fed import FederatedSimulation
    batcher, params, ks = _population_parts(m, pop, device, sampler)
    fed = FedConfig(**{**dict(
        algorithm="fedagrac", n_clients=m, k_mean=pop["k"], lr=pop["lr"],
        calibration_rate=pop["lam"], seed=0, cohort_size=pop["cohort"],
        cohort_sampler=pop["sampler"], param_layout="flat"), **fed_kw})
    return FederatedSimulation(mlp_loss, params, fed, batcher,
                               k_schedule=ks, device=device)


def population_async_simulation(m: int, pop: dict = POPULATION,
                                device: str = "cuda", **fed_kw):
    """The same setting on the buffered-async engine: ``pop["cohort"]``
    clients in flight, a buffer of as many reports, hinge staleness, the
    lognormal σ = 1 fleet; ``fed_kw`` adds or replaces config fields."""
    from repro_torch.fed import BufferedAsyncSimulation
    batcher, params, ks = _population_parts(m, pop, device)
    fed = FedConfig(**{**dict(
        algorithm="fedagrac", n_clients=m, k_mean=pop["k"], lr=pop["lr"],
        calibration_rate=pop["lam"], seed=0, cohort_size=pop["cohort"],
        cohort_sampler=pop["sampler"], buffer_size=pop["cohort"],
        staleness="hinge", speed_dist="lognormal", speed_sigma=1.0,
        param_layout="flat"), **fed_kw})
    return BufferedAsyncSimulation(mlp_loss, params, fed, batcher,
                                   k_schedule=ks, device=device)


def profile_population(m: int, top: int = 8, buffered: bool = False
                       ) -> dict:
    chunk = POPULATION["chunk"]
    if buffered:
        sim = population_async_simulation(m)
        kw = {"chunk_updates": chunk}
    else:
        sim = population_simulation(m)
        kw = {"chunk_rounds": chunk}
    sim.run(chunk, **kw)                                    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        sim.run(chunk, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    return {"population": m, "cohort": POPULATION["cohort"],
            "k": POPULATION["k"], "rounds": chunk,
            "engine": "buffered_async" if buffered else "cohort_round",
            **_breakdown(prof, wall_us, chunk * POPULATION["k"], chunk,
                         top)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algorithms", default="fedavg,fedprox,fednova,fedagrac")
    ap.add_argument("--population", type=int, default=0,
                    help="profile cohort rounds on this many clients")
    ap.add_argument("--buffered", action="store_true",
                    help="with --population: buffered-async updates "
                         "instead of cohort rounds")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.population:
        print(json.dumps(profile_population(args.population,
                                            buffered=args.buffered)),
              flush=True)
        return
    for algo in args.algorithms.split(","):
        print(json.dumps(profile_round(algo)), flush=True)


if __name__ == "__main__":
    main()
