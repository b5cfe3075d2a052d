"""Federated LM training on the synchronous round: the port's twin of
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
client matrix.  ``--layout tree`` runs the tree round instead: the same
forward and backward, and the update leaf by leaf in plain torch.  Batches come from the host sampler (``LMFederatedBatcher``)
or, with ``--sampler device``, from ``DeviceLMBatcher``: the streams live
on the device and each chunk of rounds draws its batches there.  The token
streams are drawn from numpy seeds, so they are not the reference's
(``jax.random.choice`` has no twin here).  At every eval boundary the
global model is saved to ``--ckpt`` (a ``{round}`` format, the reference's
checkpoint format; ``--ckpt ""`` saves nothing), as the reference does.

``--bf16`` runs the mixed-precision configuration: bfloat16 parameters and
compute over a float32 flat master (``FedConfig.master_dtype``), so the
attention kernels run in bfloat16 and the calibrated update on the
float32 master (the master is the flat buffer: ``--layout flat`` only, as
in the reference).  ``--small`` shrinks to a 2-layer d = 64 model.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Optional

import torch

from repro_torch import checkpoint
from repro_torch.configs.base import FedConfig, ModelConfig, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data import DeviceLMBatcher, LMFederatedBatcher, lm_sequences
from repro_torch.device import resolve_device
from repro_torch.fed import FederatedSimulation
from repro_torch.models import model as M

MCLIENTS = 4
STREAM_SEQS, HELD_OUT_SEQS, HELD_OUT_SEED = 128, 8, 999
# checkpoints at every eval boundary, under the gitignored build directory
DEFAULT_CKPT = "build/fed_lm/fed_lm_{round}.msgpack"


def build_config(small: bool, bf16: bool = False) -> ModelConfig:
    """The example's model; ``bf16`` makes its parameters and compute
    bfloat16 (the float32 master is ``fed_config``'s)."""
    base = get_arch("gemma-2b")
    cfg = (reduced(base, n_layers=2, d_model=64, vocab=256) if small
           else reduced(base, n_layers=6, d_model=512, vocab=8192))
    return dataclasses.replace(cfg, dtype="bfloat16") if bf16 else cfg


def make_streams(cfg: ModelConfig, seq: int,
                 n_clients: int = MCLIENTS) -> list[dict]:
    """Client i's stream: STREAM_SEQS sequences from seed i, topic band
    i."""
    return [lm_sequences(i, STREAM_SEQS, seq, cfg.vocab, skew_topic=i)
            for i in range(n_clients)]


def make_eval(cfg: ModelConfig, seq: int, device: torch.device,
              n_seqs: int = HELD_OUT_SEQS):
    """Held-out perplexity ``exp(lm_loss)`` on ``n_seqs`` sequences of
    topic 1 (HELD_OUT_SEQS, as the reference's example evaluates)."""
    held_out = {k: v.to(device) for k, v in
                lm_sequences(HELD_OUT_SEED, n_seqs, seq, cfg.vocab,
                             skew_topic=1).items()}

    def eval_ppl(params) -> float:
        with torch.no_grad():
            return float(torch.exp(M.lm_loss(params, held_out, cfg)))

    return eval_ppl


def make_simulation(cfg: ModelConfig, fed: FedConfig, *, seq: int,
                    batch: int, rounds: int, device: torch.device,
                    generator: Optional[torch.Generator] = None,
                    batcher=None, sampler: str = "host",
                    held_out: int = HELD_OUT_SEQS) -> FederatedSimulation:
    """The example's simulation: random weights from ``generator`` (seed 0
    on ``device`` by default), the host (``sampler="host"``) or device LM
    batcher over ``make_streams`` (or ``batcher``), the held-out perplexity
    on ``held_out`` sequences as the eval metric, K_i drawn for ``rounds``
    rounds."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(generator, cfg, device=device)
    if batcher is None:
        batcher_cls = {"host": LMFederatedBatcher,
                       "device": DeviceLMBatcher}[sampler]
        batcher = batcher_cls(make_streams(cfg, seq, fed.n_clients),
                              batch_size=batch, device=device)
    loss_fn = functools.partial(M.lm_loss, cfg=cfg)
    return FederatedSimulation(lambda p, b: loss_fn(p, b), params, fed,
                               batcher,
                               eval_fn=make_eval(cfg, seq, device, held_out),
                               t_max=max(rounds, 1), device=device)


def fed_config(algo: str, n_clients: int = MCLIENTS,
               bf16: bool = False, layout: str = "flat") -> FedConfig:
    """The example's round: K_i ~ N(4, 2²), lr 0.3, λ 0.5, on ``layout``;
    ``bf16`` keeps the state in a float32 master (``master_dtype``)."""
    return FedConfig(algorithm=algo, n_clients=n_clients, k_mean=4,
                     k_var=4.0, lr=0.3, calibration_rate=0.5,
                     param_layout=layout,
                     master_dtype="float32" if bf16 else "")


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
                    help="bf16 params/compute + f32 flat master buffer")
    ap.add_argument("--sampler", choices=("device", "host"), default="host")
    ap.add_argument("--eval-every", type=int, default=5,
                    help="eval/checkpoint cadence = round-chunk length")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT,
                    help="checkpoint path format with {round}; '' saves "
                         "none")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.bf16 and args.layout != "flat":
        raise SystemExit("--bf16 requires --layout flat (the f32 master IS "
                         "the flat buffer)")

    device = resolve_device(args.device)
    cfg = build_config(args.small, args.bf16)
    seq = min(args.seq, 32) if args.small else args.seq
    print(f"model: gemma-family {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} dtype={cfg.dtype}  "
          f"params ≈ {cfg.param_count() / 1e6:.1f}M  layout={args.layout}"
          + (" (f32 master)" if args.bf16 else "") + f"  device={device}")
    sim = make_simulation(cfg, fed_config(args.algo, bf16=args.bf16,
                                          layout=args.layout),
                          seq=seq, batch=args.batch, rounds=args.rounds,
                          device=device, sampler=args.sampler)
    ckpt_cb = (checkpoint.save_every(args.ckpt, every=args.eval_every)
               if args.ckpt else lambda t, tree: None)
    t0 = time.time()
    done = 0
    while done < args.rounds:
        r = min(args.eval_every, args.rounds - done)
        hist = sim.run(r, eval_every=r)
        done += r
        ckpt_cb(done, sim.params)
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
