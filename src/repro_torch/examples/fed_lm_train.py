"""Federated LM training on the flat synchronous round: the port's twin of
``examples/fed_lm_train.py``.

    PYTHONPATH=src python -m repro_torch.examples.fed_lm_train [--rounds 30]
    PYTHONPATH=src python -m repro_torch.examples.fed_lm_train --small \\
        --device cpu

4 clients hold topic-skewed Zipf token streams (non-IID at the unigram
level) and run K_i ~ N(4, 2²) local steps per round of a scaled-down
gemma-2b (MQA, GeGLU, tied embeddings) through ``FederatedSimulation`` on
the flat layout: each local step is one vmapped forward and backward for
all clients — attention through the flash-attention forward, dq and dk/dv
kernels on the card — and one calibrated-update launch on the ``(M, P)``
client matrix.  Batches come from the host sampler (``LMFederatedBatcher``).
The token streams are drawn from numpy seeds, so they are not the
reference's (``jax.random`` has no twin here).

Not ported yet, and refused by name: ``--bf16`` (the mixed-precision
master buffer, ROADMAP A3), ``--sampler device`` (``DeviceLMBatcher``,
ROADMAP A5), ``--layout tree`` (ROADMAP A2) and ``--ckpt`` (checkpoints,
ROADMAP A11).  ``--small`` shrinks to a 2-layer d = 64 model.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Optional

import torch

from repro_torch.configs.base import FedConfig, ModelConfig, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data import LMFederatedBatcher, lm_sequences
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models import model as M

MCLIENTS = 4
STREAM_SEQS, HELD_OUT_SEQS, HELD_OUT_SEED = 128, 8, 999


def build_config(small: bool) -> ModelConfig:
    base = get_arch("gemma-2b")
    if small:
        return reduced(base, n_layers=2, d_model=64, vocab=256)
    return reduced(base, n_layers=6, d_model=512, vocab=8192)


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for a flag whose feature the port does
    not run yet, naming its ROADMAP item."""
    unported = [
        (args.bf16, "--bf16 (the mixed-precision master buffer, "
                    "FedConfig.master_dtype: ROADMAP A3)"),
        (args.sampler == "device", "--sampler device (DeviceLMBatcher: "
                                   "ROADMAP A5)"),
        (args.layout != "flat", "--layout tree (ROADMAP A2)"),
        (args.ckpt is not None, "--ckpt (checkpoints: ROADMAP A11)")]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"the PyTorch port does not run {what}"
                                      f" yet")


def make_streams(cfg: ModelConfig, seq: int,
                 n_clients: int = MCLIENTS) -> list[dict]:
    """Client i's stream: STREAM_SEQS sequences from seed i, topic band
    i."""
    return [lm_sequences(i, STREAM_SEQS, seq, cfg.vocab, skew_topic=i)
            for i in range(n_clients)]


def make_eval(cfg: ModelConfig, seq: int, device: torch.device):
    """Held-out perplexity ``exp(lm_loss)`` on HELD_OUT_SEQS sequences of
    topic 1, as the reference's example evaluates."""
    held_out = {k: v.to(device) for k, v in
                lm_sequences(HELD_OUT_SEED, HELD_OUT_SEQS, seq, cfg.vocab,
                             skew_topic=1).items()}

    def eval_ppl(params) -> float:
        with torch.no_grad():
            return float(torch.exp(M.lm_loss(params, held_out, cfg)))

    return eval_ppl


def make_simulation(cfg: ModelConfig, fed: FedConfig, *, seq: int,
                    batch: int, rounds: int, device: torch.device,
                    generator: Optional[torch.Generator] = None,
                    batcher: Optional[LMFederatedBatcher] = None
                    ) -> FederatedSimulation:
    """The example's simulation: random weights from ``generator`` (seed 0
    on ``device`` by default), the host LM batcher over ``make_streams``
    (or ``batcher``), the held-out perplexity as the eval metric, K_i drawn
    for ``rounds`` rounds."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(generator, cfg, device=device)
    if batcher is None:
        batcher = LMFederatedBatcher(make_streams(cfg, seq, fed.n_clients),
                                     batch_size=batch, device=device)
    loss_fn = functools.partial(M.lm_loss, cfg=cfg)
    return FederatedSimulation(lambda p, b: loss_fn(p, b), params, fed,
                               batcher, eval_fn=make_eval(cfg, seq, device),
                               t_max=max(rounds, 1), device=device)


def fed_config(algo: str, n_clients: int = MCLIENTS) -> FedConfig:
    """The example's round: K_i ~ N(4, 2²), lr 0.3, λ 0.5."""
    return FedConfig(algorithm=algo, n_clients=n_clients, k_mean=4,
                     k_var=4.0, lr=0.3, calibration_rate=0.5,
                     param_layout="flat")


def main(argv: Optional[list] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--small", action="store_true",
                    help="2-layer reduced model")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--algo", default="fedagrac")
    ap.add_argument("--layout", choices=("flat", "tree"), default="flat")
    ap.add_argument("--bf16", action="store_true",
                    help="not ported yet (ROADMAP A3)")
    ap.add_argument("--sampler", choices=("device", "host"), default="host")
    ap.add_argument("--eval-every", type=int, default=5,
                    help="eval cadence = round-chunk length")
    ap.add_argument("--ckpt", default=None,
                    help="not ported yet (ROADMAP A11)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    refuse_unported(args)

    device = resolve_device(args.device)
    cfg = build_config(args.small)
    seq = min(args.seq, 32) if args.small else args.seq
    print(f"model: gemma-family {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} dtype={cfg.dtype}  "
          f"params ≈ {cfg.param_count() / 1e6:.1f}M  layout=flat  "
          f"device={device}")
    sim = make_simulation(cfg, fed_config(args.algo), seq=seq,
                          batch=args.batch, rounds=args.rounds,
                          device=device)
    t0 = time.time()
    done = 0
    while done < args.rounds:
        r = min(args.eval_every, args.rounds - done)
        hist = sim.run(r, eval_every=r)
        done += r
        print(f"round {done:3d}  train loss {hist.loss[-1]:.4f}  "
              f"held-out ppl {hist.metric[-1]:.1f}  "
              f"({time.time() - t0:.0f}s)", flush=True)
    final = sim.eval_fn(sim.params)
    print(f"\nfinal held-out perplexity: {final:.1f} "
          f"(uniform baseline {cfg.vocab})")
    assert final < 0.8 * cfg.vocab, "model failed to learn"
    return final


if __name__ == "__main__":
    main()
