"""Engine throughput: host-driven per-round loop vs chunked rounds.

The twin of ``benchmarks/engine_bench.py``'s sync and async parts
(``_sync_rounds_per_s`` and ``_async_updates_per_s``): the per-round loop
(one round, one host sync) against chunks of rounds fed by one
host-stacked gather and transfer per chunk
(``FederatedSimulation.run(chunk_rounds=)``, core/engine.py) and against
device-sampled chunks (``DeviceBatcher``: the chunk draws its batches on
the device), and the buffered-async engine's per-update runs against its
host and device chunks (``BufferedAsyncSimulation.run(chunk_updates=)``).
This is the baseline that capturing the chunk in a CUDA graph (ROADMAP
A4) is measured against.  Not run here, and named in the report: the
tree-vs-flat layout rows (the tree layout, ROADMAP A2).

    PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench \\
        [--quick] [--device cpu] [--out PATH]

Prints the rows as CSV, then the JSON report (to ``--out`` instead, where
given); it writes no ``BENCH_engine.json``.  Runs on the card unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.benchmarks.common import M_CLIENTS, emit, make_task
from repro_torch.configs.base import FedConfig
from repro_torch.device import resolve_device
from repro_torch.fed import BufferedAsyncSimulation, FederatedSimulation

REPEATS = 3           # best-of-N: a host loop's time varies run to run
CHUNK = 40
T_ROUNDS, T_ROUNDS_QUICK = 160, 80
# K̄ = 4 is the FedConfig default round shape; the host loop is
# dispatch/transfer-bound there — exactly the regime chunking targets
K_MEAN, K_MEAN_QUICK = 8, 4
NOT_RUN = {"layout": "the tree layout, ROADMAP A2"}


def _sync_rounds_per_s(kind: str, sampler: str, chunk_rounds: int,
                       t_rounds: int, k_mean: int, device,
                       seed: int = 0) -> float:
    task = make_task(kind, noniid=True, seed=seed, sampler=sampler,
                     device=device)
    fed = FedConfig(algorithm="fedagrac", n_clients=task.batcher.m,
                    k_mean=k_mean, lr=task.lr, calibration_rate=0.5,
                    weights="data", seed=seed, param_layout="flat")
    sim = FederatedSimulation(task.loss_fn, task.params, fed, task.batcher,
                              device=task.device)
    sim.run(min(chunk_rounds, t_rounds),
            chunk_rounds=chunk_rounds)                  # warm-up
    best = 0.0
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        sim.run(t_rounds, chunk_rounds=chunk_rounds)
        best = max(best, t_rounds / (time.perf_counter() - t0))
    return best


def _async_updates_per_s(kind: str, sampler: str, chunk_updates: int,
                         t_updates: int, k_mean: int, device,
                         seed: int = 0) -> float:
    task = make_task(kind, noniid=True, seed=seed, sampler=sampler,
                     device=device)
    m = task.batcher.m
    fed = FedConfig(algorithm="fedagrac", n_clients=m, k_mean=k_mean,
                    lr=task.lr, calibration_rate=0.5, weights="data",
                    buffer_size=4 * m // 5, staleness="hinge",
                    speed_dist="lognormal", speed_sigma=1.0, seed=seed,
                    param_layout="flat")
    sim = BufferedAsyncSimulation(task.loss_fn, task.params, fed,
                                  task.batcher, device=task.device)
    sim.run(min(chunk_updates, t_updates),
            chunk_updates=chunk_updates)                # warm-up
    best = 0.0
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        sim.run(t_updates, chunk_updates=chunk_updates)
        best = max(best, t_updates / (time.perf_counter() - t0))
    return best


def report(quick: bool = False, device=None) -> tuple[list, dict]:
    """(CSV rows, JSON report) of both engines' rows."""
    device = resolve_device(device)
    t_rounds = T_ROUNDS_QUICK if quick else T_ROUNDS
    k_mean = K_MEAN_QUICK if quick else K_MEAN
    rows, out = [], {"sync": {}, "async": {}}
    for kind in (("lr",) if quick else ("lr", "mlp")):
        host_loop = _sync_rounds_per_s(kind, "host", 1, t_rounds, k_mean,
                                       device)
        chunked = _sync_rounds_per_s(kind, "host", CHUNK, t_rounds, k_mean,
                                     device)
        chunked_dev = _sync_rounds_per_s(kind, "device", CHUNK, t_rounds,
                                         k_mean, device)
        out["sync"][kind] = {
            "host_loop_rounds_per_s": host_loop,
            "chunked_host_rounds_per_s": chunked,
            "chunked_device_rounds_per_s": chunked_dev,
            "speedup_chunked_host": chunked / host_loop,
            "speedup_chunked_device": chunked_dev / host_loop,
        }
        rows += [(kind, "sync", "host_loop", 1, f"{host_loop:.1f}", "1.00"),
                 (kind, "sync", "chunked_host", CHUNK, f"{chunked:.1f}",
                  f"{chunked / host_loop:.2f}"),
                 (kind, "sync", "chunked_device", CHUNK,
                  f"{chunked_dev:.1f}", f"{chunked_dev / host_loop:.2f}")]
        per_update = _async_updates_per_s(kind, "host", 1, t_rounds, k_mean,
                                          device)
        chunked_a = _async_updates_per_s(kind, "host", CHUNK, t_rounds,
                                         k_mean, device)
        chunked_ad = _async_updates_per_s(kind, "device", CHUNK, t_rounds,
                                          k_mean, device)
        out["async"][kind] = {
            "per_update_updates_per_s": per_update,
            "chunked_host_updates_per_s": chunked_a,
            "chunked_device_updates_per_s": chunked_ad,
            "speedup_chunked_host": chunked_a / per_update,
            "speedup_chunked_device": chunked_ad / per_update,
        }
        rows += [(kind, "async", "per_update", 1, f"{per_update:.1f}",
                  "1.00"),
                 (kind, "async", "chunked_host", CHUNK, f"{chunked_a:.1f}",
                  f"{chunked_a / per_update:.2f}"),
                 (kind, "async", "chunked_device", CHUNK,
                  f"{chunked_ad:.1f}", f"{chunked_ad / per_update:.2f}")]
    out["meta"] = {
        "quick": quick,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "m_clients": M_CLIENTS,
        "k_local_steps": k_mean,
        "t_rounds": t_rounds,
        "chunk": CHUNK,
        "algorithm": "fedagrac",
        "unit": "rounds/s (sync), server updates/s (async)",
        "not_run": NOT_RUN,
    }
    return rows, out


def main(quick: bool = False, device=None, out: Optional[str] = None
         ) -> None:
    rows, rep = report(quick, device)
    emit(rows, ("task", "engine", "mode", "chunk", "throughput_per_s",
                "speedup"))
    text = json.dumps(rep, indent=2, sort_keys=True)
    if out is None:
        print(text)
    else:
        Path(out).write_text(text + "\n")
        print(f"# wrote {out}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here instead of stdout")
    args = ap.parse_args()
    main(args.quick, args.device, args.out)
