"""Where the serving path spends its time on the card.

    PYTHONPATH=src python -m repro_torch.roofline.serve_profile

Builds llama3-8b at full width and depth in bfloat16 (random weights from
a seed) behind a ``ServeEngine`` with 4 slots, max_len 512 and buckets
(32, 64, 128, 256), as ``chip_smoke.py`` phase 6 does; fills three slots
and runs two warm steps, then profiles with ``torch.profiler`` one
admission of a 240-token prompt (bucket 256) into the free slot and one
decode tick of the four live slots.  Prints one JSON line each: host wall
time, the device's busy time (the union of kernel intervals) and idle
share, kernel launches, the attention kernel's device time, and the
kernels by device time.  Needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_arch
from repro_torch.models.model import init_params
from repro_torch.roofline.round_profile import _busy_us
from repro_torch.serving import Request, ServeEngine

SLOTS, MAX_LEN, BUCKETS = 4, 512, (32, 64, 128, 256)


def _profiled(name: str, fn, device: torch.device, top: int) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        with torch.inference_mode():
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    return {"step": name, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches": len(kernels),
            "flash_attention_ms": sum(
                t for k, (_, t) in by_name.items()
                if "flash_fwd_kernel" in k) / 1e3,
            "top_kernels": [
                {"name": k[:80], "launches": n, "ms": t / 1e3}
                for k, (n, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])[:top]]}


def profile_serving(cfg: ModelConfig, device: str = "cuda",
                    top: int = 10) -> list[dict]:
    dev = torch.device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      prefill_buckets=BUCKETS, device=dev)
    rng = np.random.default_rng(0)

    def request(uid: int, n: int) -> Request:
        return Request(uid=uid, max_new_tokens=64,
                       prompt=rng.integers(1, cfg.vocab, n).astype(np.int32))

    for uid, n in enumerate((200, 100, 50)):
        eng.submit(request(uid, n))
    eng.step()
    eng.step()
    eng.submit(request(3, 240))
    out = [_profiled("admit_240_tokens", eng._admit, dev, top),
           _profiled("decode_tick_4_slots", eng._tick, dev, top)]
    for row in out:
        row.update(model=cfg.name, dtype=cfg.dtype, n_layers=cfg.n_layers,
                   device=(torch.cuda.get_device_name(0)
                           if dev.type == "cuda" else "cpu"))
    return out


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3-8b"), dtype="bfloat16")
    for row in profile_serving(cfg):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
