"""Engine throughput: host-driven per-round loop vs chunked rounds.

The twin of ``benchmarks/engine_bench.py``'s sync and async parts
(``_sync_rounds_per_s`` and ``_async_updates_per_s``): the per-round loop
(one round, one host sync) against chunks of rounds fed by one
host-stacked gather and transfer per chunk
(``FederatedSimulation.run(chunk_rounds=)``, core/engine.py) and against
device-sampled chunks (``DeviceBatcher``: the chunk draws its batches on
the device), and the buffered-async engine's per-update runs against its
host and device chunks (``BufferedAsyncSimulation.run(chunk_updates=)``),
and the two parameter layouts against each other (``_layout_rounds_per_s``,
``_layout_engine_rates``: the tree round, plain torch per leaf, and the
flat round, one calibrated-update launch a local step).  This is the
baseline that capturing the chunk in a CUDA graph (ROADMAP A4) is measured
against.

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
from repro_torch.core import engine, flat, rounds
from repro_torch.core.fedopt import get_algorithm
from repro_torch.core.tree_util import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.fed import BufferedAsyncSimulation, FederatedSimulation

REPEATS = 3           # best-of-N: a host loop's time varies run to run
CHUNK = 40
T_ROUNDS, T_ROUNDS_QUICK = 160, 80
# K̄ = 4 is the FedConfig default round shape; the host loop is
# dispatch/transfer-bound there — exactly the regime chunking targets
K_MEAN, K_MEAN_QUICK = 8, 4
ENGINE_CHUNK = 20     # the round-engine rows' chunk, as in the reference


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def _layout_rounds_per_s(kind: str, chunk_rounds: int, t_rounds: int,
                         k_mean: int, device, seed: int = 0
                         ) -> tuple[float, float]:
    """(tree, flat) rounds/s of the chunked device-sampled engine under
    the two parameter layouts, measured interleaved (tree, flat, tree,
    flat, …, best of 2 × REPEATS each), so both see the same ambient
    load."""
    def build(layout):
        task = make_task(kind, noniid=True, seed=seed, sampler="device",
                         device=device)
        fed = FedConfig(algorithm="fedagrac", n_clients=task.batcher.m,
                        k_mean=k_mean, lr=task.lr, calibration_rate=0.5,
                        weights="data", seed=seed, param_layout=layout)
        sim = FederatedSimulation(task.loss_fn, task.params, fed,
                                  task.batcher, device=task.device)
        sim.run(min(chunk_rounds, t_rounds),
                chunk_rounds=chunk_rounds)              # warm-up
        return sim
    sims = {"tree": build("tree"), "flat": build("flat")}
    best = {"tree": 0.0, "flat": 0.0}
    for _ in range(2 * REPEATS):
        for layout, sim in sims.items():
            t0 = time.perf_counter()
            sim.run(t_rounds, chunk_rounds=chunk_rounds)
            best[layout] = max(best[layout],
                               t_rounds / (time.perf_counter() - t0))
    return best["tree"], best["flat"]


def _zero_model_loss(params, batch):
    """A client objective of about no cost with a live gradient in every
    leaf (∇ = leaf): the round keeps every engine stage (the k local
    steps, the K_i mask, aggregation, orientation, the ν updates, the
    server step) without the model."""
    return 0.5 * sum((lv * lv).sum() for lv in tree_leaves(params))


def _layout_engine_rates(kind: str, k_mean: int, device, seed: int = 0
                         ) -> tuple[float, float, float]:
    """(tree, flat, grad_fraction): rounds/s of the round engine alone —
    the chunked round with the model's loss replaced by
    ``_zero_model_loss``, at one local step, where the round's state
    algebra is the round — and the share of the real tree round (at
    ``k_mean`` steps) its model's loss and gradient take."""
    task = make_task(kind, noniid=True, seed=seed, sampler="host",
                     device=device)
    m, chunk = task.batcher.m, ENGINE_CHUNK
    fed = FedConfig(algorithm="fedagrac", n_clients=m, k_mean=k_mean,
                    lr=task.lr, calibration_rate=0.5, weights="data",
                    seed=seed)
    algo = get_algorithm("fedagrac", fed)
    spec = flat.make_flat_spec(task.params)
    batches = task.batcher.round_batches(0, k_mean)
    ws = task.batcher.weights.expand(chunk, m)
    lams = [0.5] * chunk

    def build(loss_fn, layout, k_max):
        if layout == "flat":
            fn = flat.make_flat_round(spec, loss_fn, algo, lr=task.lr,
                                      k_max=k_max)
            st = rounds.init_state(flat.ravel(spec, task.params), m, algo)
        else:
            fn = rounds.make_round(loss_fn, algo, lr=task.lr, k_max=k_max)
            st = rounds.init_state(task.params, m, algo)
        ch = engine.make_round_chunk(fn, chunk)
        b = {key: v[:, :k_max].expand((chunk,) + v[:, :k_max].shape)
             for key, v in batches.items()}
        kk = torch.full((chunk, m), k_max, dtype=torch.int32,
                        device=task.device)
        args = (st, b, kk, ws, lams)
        ch(*args)                                       # warm-up
        return ch, args

    builds = {("eng", "tree"): build(_zero_model_loss, "tree", 1),
              ("eng", "flat"): build(_zero_model_loss, "flat", 1),
              ("engk", "tree"): build(_zero_model_loss, "tree", k_mean),
              ("full", "tree"): build(task.loss_fn, "tree", k_mean)}
    best = {key: 0.0 for key in builds}
    for _ in range(2 * REPEATS):
        for key, (ch, args) in builds.items():
            _sync(task.device)
            t0 = time.perf_counter()
            ch(*args)
            _sync(task.device)
            best[key] = max(best[key], chunk / (time.perf_counter() - t0))
    grad_frac = max(0.0, 1.0 - best[("full", "tree")]
                    / best[("engk", "tree")])
    return best[("eng", "tree")], best[("eng", "flat")], grad_frac


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
    """(CSV rows, JSON report) of both engines' rows and the layouts'."""
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
    # the layouts: the end-to-end rows are capped by the model's share of
    # the round (the per-client gradients are the same on both layouts),
    # so the round engine alone is measured too (``layout_engine``)
    out["layout"] = {}
    for kind in ("lr", "mlp"):
        tree_rps, flat_rps = _layout_rounds_per_s(kind, CHUNK, t_rounds,
                                                  k_mean, device)
        eng_tree, eng_flat, grad_frac = _layout_engine_rates(kind, k_mean,
                                                             device)
        out["layout"][kind] = {
            "tree_rounds_per_s": tree_rps,
            "flat_rounds_per_s": flat_rps,
            "speedup_flat": flat_rps / tree_rps,
            "engine_tree_rounds_per_s": eng_tree,
            "engine_flat_rounds_per_s": eng_flat,
            "engine_speedup_flat": eng_flat / eng_tree,
            "grad_fraction_tree": grad_frac,
        }
        rows += [(kind, "layout", "tree", CHUNK, f"{tree_rps:.1f}", "1.00"),
                 (kind, "layout", "flat", CHUNK, f"{flat_rps:.1f}",
                  f"{flat_rps / tree_rps:.2f}"),
                 (kind, "layout_engine", "tree", 1, f"{eng_tree:.1f}",
                  "1.00"),
                 (kind, "layout_engine", "flat", 1, f"{eng_flat:.1f}",
                  f"{eng_flat / eng_tree:.2f}")]
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
        "unit": "rounds/s (sync, layout), server updates/s (async)",
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
