"""Where a local step of the federated LM training path spends its time on
the card.

    PYTHONPATH=src python -m repro_torch.roofline.train_profile [--hybrid]

Builds the model of ``chip_smoke.py`` phase 8 — gemma-2b at full width
(d 2048, 8 heads / 1 kv head, head dim 256, d_ff 16384, vocab 256000) in
float32, cut to 2 layers, random weights from a seed — and the example's
batches (2 clients, batch 2, seq 128); with ``--hybrid`` phase 17's —
zamba2-2.7b at full width (d 2560, 80 SSM heads of dim 64, d_state 64,
chunk 128, 32 attention heads of dim 80, d_ff 10240, vocab 32000) in
float32, cut to 12 layers (two groups), at seq 256 — and runs one local
step of the flat
fedagrac round warm (``core/flat.py`` ``make_flat_client_update`` with
k_max 1: one vmapped forward and backward for both clients, then one
calibrated-update launch on the ``(M, P)`` client matrix), then profiles
one more with ``torch.profiler``.  Prints one JSON line: host wall time,
the device's busy time (the union of kernel intervals) and idle share,
kernel launches, the device time and share of the attention kernels
(forward, dq, dk/dv), of the SSD forward and backward kernels, of the
GEMMs and of the calibrated update, and the kernels by device time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import FedConfig, ModelConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import flat
from repro_torch.core.fedopt import get_algorithm
from repro_torch.data import LMFederatedBatcher, lm_sequences
from repro_torch.models import model as M
from repro_torch.roofline.round_profile import _busy_us

LAYERS, CLIENTS, BATCH, SEQ = 2, 2, 2, 128
# --hybrid: chip_smoke.py phase 17's cut and sequence length
HYBRID_LAYERS, HYBRID_SEQ = 12, 256
# kernel-name pieces of each share reported (the hand-written kernels'
# names, and the GEMM kernels of cuBLAS / CUTLASS)
GROUPS = {"flash_attention_fwd": ("flash_fwd_kernel",),
          "flash_attention_bwd_dq": ("dq_kernel",),
          "flash_attention_bwd_dkv": ("dkv_kernel",),
          "ssd_scan": ("ssd_scan_kernel",),
          "ssd_scan_bwd": ("ssd_bwd_",),
          "calibrated_update": ("calibrated_update",),
          "gemm": ("gemm", "cutlass", "sm90_xmma")}


def profile_local_step(cfg: ModelConfig, device: str = "cuda",
                       top: int = 12, seq: int = SEQ) -> dict:
    dev = torch.device(device)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    spec = flat.make_flat_spec(params)
    anchor = flat.ravel(spec, params)
    del params
    fed = FedConfig(algorithm="fedagrac", n_clients=CLIENTS, lr=0.003,
                    calibration_rate=0.5, param_layout="flat")
    algo = get_algorithm("fedagrac", fed)
    loss_fn = functools.partial(M.lm_loss, cfg=cfg)
    step = flat.make_flat_client_update(spec, lambda p, b: loss_fn(p, b),
                                        algo, lr=fed.lr, k_max=1)
    batcher = LMFederatedBatcher(
        [lm_sequences(i, 16, seq, cfg.vocab, skew_topic=i)
         for i in range(CLIENTS)], batch_size=BATCH, device=dev)
    batches = batcher.round_batches(0, 1)
    c_all = torch.zeros((CLIENTS, spec.p), dtype=spec.dtype, device=dev)
    k_steps = torch.ones(CLIENTS, dtype=torch.int32, device=dev)

    def run():
        return step(anchor, c_all, batches, k_steps, fed.calibration_rate)

    run()                                       # warm: handles, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    del out
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    groups = {}
    for group, pieces in GROUPS.items():
        hits = [(n, t) for k, (n, t) in by_name.items()
                if any(piece in k.lower() for piece in pieces)]
        ms = sum(t for _, t in hits) / 1e3
        groups[group] = {"launches": sum(n for n, _ in hits), "ms": ms,
                         "share_of_busy": ms * 1e3 / busy if busy else None}
    return {"step": "local_step", "model": cfg.name, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "clients": CLIENTS, "batch": BATCH,
            "seq": seq, "params": spec.n,
            "device": torch.cuda.get_device_name(0),
            "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches": len(kernels), "groups": groups,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "top_kernels": [
                {"name": k[:80], "launches": n, "ms": t / 1e3}
                for k, (n, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])[:top]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hybrid", action="store_true",
                    help="profile zamba2-2.7b (12 layers, seq 256) instead "
                         "of gemma-2b")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.hybrid:
        cfg = dataclasses.replace(get_arch("zamba2-2.7b"),
                                  n_layers=HYBRID_LAYERS, dtype="float32")
        row = profile_local_step(cfg, seq=HYBRID_SEQ)
    else:
        cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=LAYERS,
                                  dtype="float32")
        row = profile_local_step(cfg)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
