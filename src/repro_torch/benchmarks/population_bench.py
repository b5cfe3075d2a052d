"""Population scaling: round cost follows the cohort C, not the population
M — the port's twin of ``benchmarks/population_bench.py``.

The sweep holds a uniform cohort of C = 8 fixed and grows M from 32 to
100,000 on the device-sampled cohort chunk (``DeviceBatcher``; the cohort,
its batches and the keyed indices are drawn in the chunk, O(C) a round),
for FedAvg and FedaGrac on the lr model over ``gaussian_classification``
data (the reference's law, drawn from a torch generator: the timing
sweep does not need the reference's bits).  Per-round time and the
materialized batch bytes should stay flat in M; only the resident
per-client calibration state (``nu_i``) grows with it.

    PYTHONPATH=src python -m repro_torch.benchmarks.population_bench \\
        [--quick] [--device cpu] [--out PATH]

Prints the rows as CSV, then the JSON report (to ``--out`` instead, where
given); it never writes ``BENCH_population.json`` (its figures go to
PERF.md).  Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import FedConfig
from repro_torch.data import (DeviceBatcher, gaussian_classification,
                              iid_partition)
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models.simple import lr_loss

C, K_MEAN, BATCH = 8, 4, 16
D, N_CLASSES = 60, 10
N_DATA = 4096                 # global dataset FIXED: only M grows
REPEATS = 3                   # best-of-N: a host loop's time varies


def _tensors_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def one_scale(m: int, algorithm: str, t_rounds: int, chunk: int, device,
              seed: int = 0) -> dict:
    """One M of the sweep: rounds/s (best of ``REPEATS`` runs after a
    warm-up chunk), the batch bytes a round materializes against a full
    wave's, and the M-resident state and dataset bytes."""
    device = resolve_device(device)
    # every client needs a non-empty partition, so beyond N_DATA/2 clients
    # the dataset grows at 2 samples a client (reported apart)
    data = gaussian_classification(
        torch.Generator(device=device).manual_seed(seed),
        max(N_DATA, 2 * m), d=D, n_classes=N_CLASSES)
    parts = iid_partition(len(data), m, seed=seed)
    batcher = DeviceBatcher(data, parts, batch_size=BATCH, seed=seed,
                            device=device)
    fed = FedConfig(algorithm=algorithm, n_clients=m, k_mean=K_MEAN,
                    lr=0.05, calibration_rate=0.5, seed=seed, cohort_size=C,
                    cohort_sampler="uniform", param_layout="flat")
    params = {"w": torch.zeros(D, N_CLASSES, device=device),
              "b": torch.zeros(N_CLASSES, device=device)}
    # one schedule row: the default builder would allocate (10k, M)
    ks = np.full((1, m), K_MEAN, np.int32)
    sim = FederatedSimulation(lr_loss, params, fed, batcher, k_schedule=ks,
                              device=device)
    sim.run(min(chunk, t_rounds), chunk_rounds=chunk)      # warm-up
    best = 0.0
    for _ in range(REPEATS):
        _sync(device)
        t0 = time.perf_counter()
        sim.run(t_rounds, chunk_rounds=chunk)
        best = max(best, t_rounds / (time.perf_counter() - t0))
    return {
        "m": m,
        "algorithm": algorithm,
        "rounds_per_s": best,
        "ms_per_round": 1e3 / best,
        "cohort_batch_bytes": C * K_MEAN * BATCH * (D + 1) * 4,
        "full_wave_batch_bytes": m * K_MEAN * BATCH * (D + 1) * 4,
        "state_bytes": _tensors_bytes(sim.state.values()),
        "dataset_bytes": len(data) * (D + 1) * 4,
        "device_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


def report(quick: bool = False, device=None) -> tuple[list, dict]:
    device = resolve_device(device)
    m_list = [32, 1024] if quick else [32, 1024, 100_000]
    t_rounds = 24 if quick else 48
    chunk = 12
    rows, sweep = [], []
    for algorithm in ("fedavg", "fedagrac"):
        for m in m_list:
            r = one_scale(m, algorithm, t_rounds, chunk, device)
            sweep.append(r)
            rows.append((algorithm, m, C, f"{r['ms_per_round']:.2f}",
                         r["cohort_batch_bytes"], r["state_bytes"]))

    def ratio(algorithm):
        ms = [r["ms_per_round"] for r in sweep
              if r["algorithm"] == algorithm]
        return ms[-1] / ms[0]

    out = {
        "sweep": sweep,
        "meta": {
            "quick": quick,
            "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "torch": torch.__version__,
            "cohort_size": C, "sampler": "uniform",
            "k_local_steps": K_MEAN, "batch_size": BATCH,
            "t_rounds": t_rounds, "chunk_rounds": chunk,
            "batcher": "DeviceBatcher",
        },
        "time_ratio_largest_over_smallest": {
            a: ratio(a) for a in ("fedavg", "fedagrac")},
    }
    return rows, out


def main(quick: bool = False, device=None, out: Optional[str] = None
         ) -> dict:
    rows, rep = report(quick, device)
    emit(rows, ("algorithm", "m_population", "cohort", "ms_per_round",
                "cohort_batch_bytes", "state_bytes"))
    text = json.dumps(rep, indent=2, sort_keys=True)
    if out is None:
        print(text)
    else:
        Path(out).write_text(text + "\n")
        print(f"# wrote {out}")
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here instead of stdout")
    args = ap.parse_args()
    main(args.quick, args.device, args.out)
