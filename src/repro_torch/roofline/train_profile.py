"""Where a local step of the federated LM training path spends its time on
the card.

    PYTHONPATH=src python -m repro_torch.roofline.train_profile \
        [--hybrid | --launch]

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

With ``--launch``: ``chip_smoke.py`` phase 23's round — llama3-8b at full
width in bfloat16 over a float32 flat master, cut to 2 layers, one client
of two rows at seq 4096, k_max 2 — through the launch layer's
``build_train_round`` on a ``(1, 1)`` mesh of a one-rank group.  After a
warm round it profiles one round on the mesh, then the same round through
``make_flat_round`` on plain tensors, and one more mesh round under
``cProfile``, whose host seconds it sums by where the Python runs: DTensor
(``torch/distributed/tensor``), the port (``repro_torch``), the rest.
One JSON line each, as above.  Needs a CUDA device.
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
          "gemm": ("gemm", "cutlass", "sm90_xmma", "nvjet")}


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


def _profiled(name: str, fn, top: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall, the device's busy
    time and idle share, launches, the GROUPS' device time, the top
    kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
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
        groups[group] = {"launches": sum(n for n, _ in hits),
                         "ms": sum(t for _, t in hits) / 1e3}
    return {"step": name, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches": len(kernels), "groups": groups,
            "top_kernels": [
                {"name": k[:80], "launches": n, "ms": t / 1e3}
                for k, (n, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])[:top]]}


def _host_split(fn) -> dict:
    """Host seconds of one call of ``fn`` under ``cProfile``, summed by
    where each function's own time was spent."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    groups: dict[str, float] = defaultdict(float)
    for (path, _line, _fn), (_cc, _nc, tt, _ct, _callers) in \
            pstats.Stats(prof).stats.items():
        key = ("dtensor_s" if "torch/distributed/tensor" in path
               else "port_s" if "repro_torch" in path else "other_s")
        groups[key] += tt
    return {"step": "launch_round_cprofile", **dict(groups),
            "total_s": sum(groups.values())}


LAUNCH_ARCH = "llama3-8b"
LAUNCH = {"layers": 2, "seq": 4096, "global_batch": 2, "k_max": 2,
          "lr": 3e-2}


def profile_launch_round(top: int = 12) -> list[dict]:
    """chip_smoke.py phase 23's round on the mesh, beside the same round
    on plain tensors (see the module docstring)."""
    from repro_torch import dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import rounds
    from repro_torch.launch import specs as specs_lib, train
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda")
    mesh = make_local_mesh(1, 1, device_type="cuda")
    cfg = specs_lib.bf16_config(dataclasses.replace(
        get_arch(LAUNCH_ARCH), n_layers=LAUNCH["layers"]))
    shape = ShapeConfig("train_4k", seq_len=LAUNCH["seq"],
                        global_batch=LAUNCH["global_batch"], kind="train")
    fed = FedConfig(algorithm="fedagrac", lr=LAUNCH["lr"],
                    param_layout="flat", master_dtype="float32")
    algo = get_algorithm(fed.algorithm, fed)
    k_max = LAUNCH["k_max"]
    step, bundle = train.build_train_round(cfg, shape, mesh, fed,
                                           k_max=k_max)
    spec, m, b_local = bundle["flat_spec"], bundle["m"], bundle["b_local"]
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    master = flat.ravel(spec, params)
    del params
    batches, ks = train.round_inputs(cfg, m, k_max, b_local, shape.seq_len,
                                     0)
    batches = {k: v.to(dev) for k, v in batches.items()}
    ks = ks.to(dev)
    w = torch.full((m,), 1.0 / m, device=dev)
    plain_round = flat.make_flat_round(
        spec, lambda p, b: M.lm_loss(p, b, cfg), algo, lr=fed.lr,
        k_max=k_max)

    def mesh_round():
        step(rounds.init_state(master, m, algo), batches, ks, w)

    def plain():
        with dist.use_mesh(None, {}):
            plain_round(rounds.init_state(master, m, algo), batches, ks, w)

    mesh_round()                                 # warm: handles, allocator
    torch.cuda.synchronize()
    rows = [_profiled("launch_round", mesh_round, top),
            _profiled("plain_round", plain, top),
            _host_split(mesh_round)]
    for row in rows:
        row.update(model=cfg.name, dtype=cfg.dtype,
                   master_dtype=fed.master_dtype, n_layers=cfg.n_layers,
                   clients=m, b_local=b_local, seq=shape.seq_len,
                   k_max=k_max, params=spec.n,
                   device=torch.cuda.get_device_name(0),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--hybrid", action="store_true",
                       help="profile zamba2-2.7b (12 layers, seq 256) "
                            "instead of gemma-2b")
    which.add_argument("--launch", action="store_true",
                       help="profile chip_smoke.py phase 23's round "
                            "through the launch layer on a (1, 1) mesh, "
                            "beside the same round on plain tensors")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.launch:
        for row in profile_launch_round():
            print(json.dumps(row), flush=True)
        return
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
