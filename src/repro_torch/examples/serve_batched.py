"""Batched serving: prefill a prompt batch, then decode greedily with the
cache — the port's twin of ``examples/serve_batched.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch llama3-8b] [--device cpu]

Uses the REDUCED variant of the chosen architecture (float32), random
weights and prompts from a seed, and the ``serve_prefill`` /
``serve_decode`` entry points: a prompt batch → prefill → greedy decode
loop → each request's generated ids.  A front-end arch (audio, vision)
needs its own inputs, so the example exits for it, as the reference's
does.  Runs on the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import model as M


@torch.inference_mode()
def generate(params, prompts: np.ndarray, cfg: ModelConfig, new_tokens: int,
             device: Union[str, torch.device]) -> np.ndarray:
    """Greedy generation: ``prompts`` (B, S0) int → (B, new_tokens) ids.
    The caches hold S0 + new_tokens positions."""
    B, S0 = prompts.shape
    toks = torch.tensor(np.asarray(prompts), dtype=torch.long,
                        device=device)
    caches = M.init_caches(cfg, B, S0 + new_tokens, torch.float32, device)
    logits, caches = M.serve_prefill(params, {"tokens": toks}, cfg,
                                     caches=caches)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for s in range(new_tokens - 1):
        logits, caches = M.serve_decode(params, {"tokens": tok[:, None]},
                                        caches, S0 + s, cfg)
        tok = logits[:, 0].argmax(-1)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()


def main(argv: Optional[list] = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} needs a modality frontend — use a "
                         f"text arch for this example")
    device = resolve_device(args.device)
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    B, S0, T = args.batch, args.prompt_len, args.new_tokens
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, S0))

    t0 = time.time()
    gen = generate(params, prompts, cfg, T, device)
    dt = time.time() - t0
    for i in range(B):
        print(f"req {i}: prompt={prompts[i][:8]}... "
              f"generated={gen[i][:12]}...")
    print(f"\n{B} requests × {T} tokens in {dt:.2f}s "
          f"({B * T / dt:.1f} tok/s on {device.type}, reduced {args.arch})")
    assert np.all(gen >= 0) and np.all(gen < cfg.vocab)
    return gen


if __name__ == "__main__":
    main()
