"""End-to-end loop: federated training feeding a personalized serving
engine with round-boundary hot-swaps — the port's twin of
``examples/personalized_serving.py``.

    PYTHONPATH=src python -m repro_torch.examples.personalized_serving \\
        [--small] [--personalizer nu|lowrank|none] [--device cpu]

4 clients train a scaled-down gemma on topic-skewed token streams with
FedaGrac (flat layout).  After the first training leg the simulation
publishes a versioned snapshot — the ``(P,)`` flat master plus the
``(M, P)`` ν⁽ⁱ⁾ calibration rows — to disk (checkpoint/serialize.py).  A
``PersonalizedServeEngine`` serves a mixed-client request stream against
it: every ``Request.client_id`` resolves to base + ν-derived delta at
admission, so all four clients' personalized views batch into the same
decode ticks.  Training then continues; the second snapshot hot-swaps in
MID-STREAM while a long request is still decoding: that request drains
under the old version, new admissions see the new weights, and each
completion records the version that served it.

The weights are drawn on the CPU from seed 0 (the same on every device)
and the token streams from numpy seeds, so neither is the reference's
(``jax.random`` has no twin here).  Runs on the card unless ``--device``
says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data import LMFederatedBatcher, lm_sequences
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models import model as M
from repro_torch.serving import (LoadGen, PersonalizedServeEngine, Request,
                                 latency_stats, load_snapshot, replay)

MCLIENTS = 4
LONG_UID = 10_000


def config(small: bool):
    cfg = reduced(get_arch("gemma-2b"), n_layers=1 if small else 2,
                  d_model=32 if small else 128)
    return dataclasses.replace(cfg, vocab=128 if small else 256)


def run(small: bool = False, rounds: int = 4, requests: int = 12,
        personalizer: str = "nu", device=None,
        engine_cls=PersonalizedServeEngine) -> dict:
    """Train, publish, serve, train, hot-swap mid-stream.  Returns the
    engine, both snapshots (as loaded), both replays' stats and the long
    request."""
    device = resolve_device(device)
    cfg = config(small)
    seq = 16 if small else 32
    streams = [lm_sequences(i, 64, seq, cfg.vocab, skew_topic=i)
               for i in range(MCLIENTS)]
    fed = FedConfig(algorithm="fedagrac", n_clients=MCLIENTS, k_mean=2,
                    k_var=0.0, lr=0.1, calibration_rate=0.5,
                    param_layout="flat")
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device=device)
    sim = FederatedSimulation(
        functools.partial(M.lm_loss, cfg=cfg), params, fed,
        LMFederatedBatcher(streams, batch_size=4, device=device),
        device=device)
    print(f"model: gemma-family {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}; P = {sim.flat_spec.p}  device={device}")

    with tempfile.TemporaryDirectory() as tmp:
        # ---- leg 1: train, publish v_r to disk --------------------------
        t0 = time.time()
        sim.run(rounds, eval_every=rounds)
        p1 = os.path.join(tmp, "snap1.msgpack")
        sim.save_snapshot(p1)
        print(f"leg 1: {rounds} rounds in {time.time() - t0:.1f}s → "
              f"published v{rounds} ({os.path.getsize(p1)} bytes)")
        snap1 = load_snapshot(p1)

        # ---- serve a mixed-client stream against it ---------------------
        eng = engine_cls(cfg, sim.flat_spec, snap1,
                         personalizer=personalizer, slots=4, max_len=64,
                         prefill_buckets=(8, 16), device=device)
        gen = LoadGen(population=MCLIENTS, rate=0.8, prompt_len=(3, 8),
                      max_new=(3, 6), vocab=cfg.vocab, seed=1)
        stats = replay(eng, gen.generate(requests))
        lat = latency_stats(stats["tick_wall"])
        print(f"served {stats['n_requests']} requests from "
              f"{MCLIENTS} clients: {stats['requests_per_s']:.1f} req/s, "
              f"tick p50 {lat['p50'] * 1e3:.1f} ms / "
              f"p99 {lat['p99'] * 1e3:.1f} ms, "
              f"utilization {stats['mean_utilization']:.2f}")

        # ---- leg 2: train more, hot-swap MID-STREAM ---------------------
        sim.run(rounds, eval_every=rounds)
        p2 = os.path.join(tmp, "snap2.msgpack")
        sim.save_snapshot(p2)
        snap2 = load_snapshot(p2)
    v1, v2 = rounds, 2 * rounds
    print(f"leg 2: published v{v2}; swapping mid-stream…")

    rng = np.random.default_rng(7)
    long_req = Request(uid=LONG_UID,
                       prompt=rng.integers(1, cfg.vocab, 6).astype(np.int32),
                       max_new_tokens=12, client_id=0)
    eng.submit(long_req)
    for _ in range(3):
        eng.step()                           # long_req is mid-decode
    eng.swap(snap2)                          # between ticks
    stats2 = replay(eng, gen.generate(requests // 2))
    by_ver = {}
    for c in stats2["completions"]:
        by_ver[c.version] = by_ver.get(c.version, 0) + 1
    print(f"post-swap drain: completions per version {by_ver}")

    assert set(by_ver) == {v1, v2}, (
        f"expected in-flight v{v1} + fresh v{v2}, got {set(by_ver)}")
    pre = next(c for c in stats2["completions"] if c.uid == LONG_UID)
    assert pre.version == v1, "in-flight request must keep its version"
    assert len(pre.tokens) == 12
    print(f"OK — in-flight request drained under v{v1} while new "
          f"admissions served v{v2}")
    return {"cfg": cfg, "spec": sim.flat_spec, "engine": eng,
            "snapshots": {v1: snap1, v2: snap2}, "stats": stats,
            "stats2": stats2, "long_request": long_req}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="1-layer reduced model")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds per training leg (two legs total)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--personalizer", default="nu",
                    choices=("none", "nu", "lowrank"))
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    return run(args.small, args.rounds, args.requests, args.personalizer,
               args.device)


if __name__ == "__main__":
    main()
