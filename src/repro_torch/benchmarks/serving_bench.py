"""Personalized serving: requests/s and tick latency vs population size.

The twin of ``benchmarks/serving_bench.py``.  Claim validated: the cost of
a personalized request is FLAT in the client population M.  A view is
resolved at admission by a row gather and one ``(P,)`` add (``lowrank``:
an ``(r,)·(r, P)`` product), never by a scan over M, so 100 000 clients
serve at the cost per tick of 32.  Deterministic seeded traces
(serving/loadgen.py) replay against ``PersonalizedServeEngine`` on a
reduced llama3 (2 layers, d_model 64, vocab 256, float32) and report:

  * the M sweep: the ``lowrank`` personalizer at M ∈ {32, 1 000,
    100 000}: requests/s, p50/p99 tick wall, utilization; the flatness
    check holds requests/s at M = 100 000 to at least 0.3 × that at 32;
  * the personalizer kinds at M = 32, "none" (the shared path) against
    "nu" ((M, P) rows) and "lowrank" (factored), on the same trace;
  * the hot-swap cost: the wall of ``swap()`` (materializing the new
    version's tree) and a replay with a swap mid-stream.

Weights and snapshots are drawn from torch seeds (the reference draws with
``jax.random``: the same laws, other numbers).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_bench \\
        [--quick] [--device cpu] [--out PATH]

Prints the rows as CSV, then the JSON report (to ``--out`` instead, where
given); it writes no ``BENCH_serving.json``.  Runs on the card unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.core import flat
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serving import (LoadGen, PersonalizedServeEngine,
                                 latency_stats, make_snapshot, replay)

RANK = 4
SLOTS = 4
POPULATIONS = (32, 1_000, 100_000)
FLAT_RATIO = 0.3


def _setup(device):
    cfg = dataclasses.replace(
        reduced(get_arch("llama3-8b"), n_layers=2, d_model=64), vocab=256)
    params = model_lib.init_params(
        torch.Generator(device=device).manual_seed(0), cfg)
    spec = flat.make_flat_spec(params)
    return cfg, spec, flat.ravel(spec, params)


def _snapshot(spec, base, kind: str, m: int, version: int = 0):
    """Synthetic per-client signal sized for ``kind``: full (M, P) ν rows
    for "nu", factored (M, r) + (r, P) for "lowrank" (at M = 100 000 the
    rows would be gigabytes, the factors ~1.6 MB)."""
    if kind == "none":
        return make_snapshot(version, base)
    gen = torch.Generator(device=base.device).manual_seed(42 + version)
    dev = base.device
    if kind == "nu":
        nu = 1e-3 * torch.randn(spec.p, generator=gen, device=dev)
        nu_i = nu[None] + 1e-3 * torch.randn(m, spec.p, generator=gen,
                                             device=dev)
        return make_snapshot(version, base, nu=nu, nu_i=nu_i)
    coeff = 1e-3 * torch.randn(m, RANK, generator=gen, device=dev)
    basis = torch.randn(RANK, spec.p, generator=gen, device=dev)
    basis = basis / torch.linalg.vector_norm(basis, dim=1, keepdim=True)
    return make_snapshot(version, base, coeff=coeff, basis=basis)


def _engine(cfg, spec, snap, kind, device):
    return PersonalizedServeEngine(cfg, spec, snap, personalizer=kind,
                                   slots=SLOTS, max_len=128,
                                   prefill_buckets=(8, 16), device=device)


def _gen(cfg, m, seed):
    return LoadGen(population=m, rate=1.0, prompt_len=(4, 14),
                   max_new=(4, 10), vocab=cfg.vocab, seed=seed, skew=2.0)


def _run(cfg, spec, base, device, *, kind: str, m: int, n_requests: int,
         seed: int = 0) -> dict:
    eng = _engine(cfg, spec, _snapshot(spec, base, kind, m), kind, device)
    # warm-up: every (bucket, path) the measured trace will take
    replay(eng, _gen(cfg, m, seed).generate(max(SLOTS * 2, 8)))
    stats = replay(eng, _gen(cfg, m, seed + 1).generate(n_requests))
    lat = latency_stats(stats["tick_wall"])
    return {"personalizer": kind, "population": m,
            "n_requests": stats["n_requests"],
            "requests_per_s": stats["requests_per_s"],
            "tick_p50_ms": lat["p50"] * 1e3,
            "tick_p99_ms": lat["p99"] * 1e3,
            "mean_utilization": stats["mean_utilization"]}


def _swap_cost(cfg, spec, base, device, m: int, n_requests: int) -> dict:
    """A replay with a version bump at the trace's midpoint, and the bare
    ``swap()`` wall."""
    eng = _engine(cfg, spec, _snapshot(spec, base, "lowrank", m),
                  "lowrank", device)
    gen = _gen(cfg, m, 5)
    replay(eng, gen.generate(SLOTS * 2))                      # warm-up
    snap2 = _snapshot(spec, base + 1e-3, "lowrank", m, version=1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.swap(snap2)
    if device.type == "cuda":
        torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    snap3 = _snapshot(spec, base + 2e-3, "lowrank", m, version=2)
    stats = replay(eng, gen.generate(n_requests), swap_at=eng.ticks + 4,
                   snapshot=snap3)
    return {"swap_ms": swap_s * 1e3,
            "mid_stream_versions_served": sorted(
                {c.version for c in stats["completions"]}),
            "requests_per_s_with_swap": stats["requests_per_s"]}


def report(quick: bool = False, device=None) -> tuple[list, dict]:
    device = resolve_device(device)
    cfg, spec, base = _setup(device)
    n_requests = 16 if quick else 48
    sweep = [_run(cfg, spec, base, device, kind="lowrank", m=m,
                  n_requests=n_requests) for m in POPULATIONS]
    kinds = [_run(cfg, spec, base, device, kind=k, m=32,
                  n_requests=n_requests) for k in ("none", "nu", "lowrank")]
    swap = _swap_cost(cfg, spec, base, device, 32, n_requests)
    rows = [(r["personalizer"], r["population"], r["n_requests"],
             f"{r['requests_per_s']:.2f}", f"{r['tick_p50_ms']:.2f}",
             f"{r['tick_p99_ms']:.2f}", f"{r['mean_utilization']:.2f}")
            for r in sweep + kinds]
    # flatness: the cost of a request must not grow with the population
    # (generous: an O(M) scan at admission would be orders of magnitude off)
    flat_ok = (sweep[-1]["requests_per_s"]
               >= FLAT_RATIO * sweep[0]["requests_per_s"])
    rep = {"population_sweep": sweep, "personalizer_kinds": kinds,
           "hot_swap": swap, "flat_in_population": bool(flat_ok),
           "meta": {"quick": quick, "device": str(device),
                    "model": "llama3-8b reduced (2 layers, d_model=64, "
                             "vocab=256)",
                    "flat_p": spec.p, "rank": RANK, "slots": SLOTS}}
    return rows, rep


def main(quick: bool = False, device=None, out: Optional[str] = None
         ) -> None:
    rows, rep = report(quick, device)
    emit(rows, ("personalizer", "M", "requests", "req_per_s",
                "tick_p50_ms", "tick_p99_ms", "utilization"))
    text = json.dumps(rep, indent=2, sort_keys=True)
    if out is None:
        print(text)
    else:
        Path(out).write_text(text + "\n")
        print(f"# wrote {out}")
    sweep = rep["population_sweep"]
    print(f"# req/s flat in M: {'OK' if rep['flat_in_population'] else 'NO'}"
          f" ({sweep[0]['requests_per_s']:.2f} @ 32 vs "
          f"{sweep[-1]['requests_per_s']:.2f} @ 100k); "
          f"swap {rep['hot_swap']['swap_ms']:.1f} ms")
    if not rep["flat_in_population"]:
        raise SystemExit("per-request cost scales with population size")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here instead of stdout")
    args = ap.parse_args()
    main(args.quick, args.device, args.out)
