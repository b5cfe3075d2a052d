"""Continuous-batching serving: ragged requests through one cache pool —
the port's twin of ``examples/continuous_batching.py``.

    PYTHONPATH=src python -m repro_torch.examples.continuous_batching \\
        [--device cpu]

Eight requests with different prompt/generation lengths stream through a
3-slot engine (llama3-8b cut to 2 layers, d 128, vocab 1024, float32,
random weights from a seed): prompts prefill into free slots (bucketed,
the flash-attention kernel on the card), every tick decodes one token for
all live slots in a single batched call, finished requests free their slot
immediately.  Batching must beat one token a tick.  Runs on the card
unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import Request, ServeEngine

# (prompt length, new tokens) of each request
REQUESTS = [(5, 12), (30, 4), (12, 20), (8, 6), (28, 10), (3, 16), (17, 8),
            (22, 5)]
SLOTS, MAX_LEN, BUCKETS = 3, 128, (8, 16, 32)


def config():
    cfg = reduced(get_arch("llama3-8b"), n_layers=2, d_model=128)
    return dataclasses.replace(cfg, vocab=1024)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config()
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab, size=int(n)).astype(
                        np.int32),
                    max_new_tokens=int(m))
            for i, (n, m) in enumerate(REQUESTS)]

    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      prefill_buckets=BUCKETS, device=device)
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total = sum(len(c.tokens) for c in done)
    print(f"{'uid':>4} {'prompt':>7} {'new':>4} {'ticks':>6}   first tokens")
    for c in sorted(done, key=lambda c: c.uid):
        print(f"{c.uid:>4} {c.prompt_len:>7} {len(c.tokens):>4} "
              f"{c.ticks:>6}   {c.tokens[:6]}")
    rate = total / max(eng.ticks, 1)
    print(f"\n{len(done)} requests, {total} tokens, {eng.ticks} engine ticks "
          f"({rate:.2f} tokens/tick vs 1.0 sequential) in {dt:.1f}s")
    if len(done) != len(reqs):
        raise RuntimeError(f"{len(done)} of {len(reqs)} requests finished")
    if rate <= 1.2:
        raise RuntimeError(f"batching gave {rate:.2f} tokens a tick; it "
                           f"should beat sequential decoding by 1.2")
    return {"completions": done, "ticks": eng.ticks, "tokens": total,
            "tokens_per_tick": rate, "wall_s": dt}


if __name__ == "__main__":
    main()
