"""Where the serving paths spend their time on the card.

    PYTHONPATH=src python -m repro_torch.roofline.serve_profile \
        [--arch NAME | --hybrid | --personalized]

Without ``--hybrid``: builds llama3-8b (or ``--arch``: any model the
engine serves, e.g. deepseek-v2-lite-16b, granite-moe-1b-a400m or
gemma3-12b, as ``chip_smoke.py`` phase 19 serves them) at full width and
depth in bfloat16 (random weights from a seed) behind a ``ServeEngine``
with 4 slots, max_len 512 and buckets (32, 64, 128, 256), as
``chip_smoke.py`` phase 6 does; fills three slots and runs two warm
steps, then profiles with ``torch.profiler`` one admission of a 240-token
prompt (bucket 256) into the free slot and one decode tick of the four
live slots.

With ``--hybrid``: builds zamba2-2.7b at full width and depth in bfloat16,
as ``chip_smoke.py`` phase 10 does; after a warm prefill and two decode
steps, profiles one ``serve_prefill`` of 4 prompts of 128 tokens and one
``serve_decode`` step of those 4 rows.

With ``--personalized``: gemma-2b at full width, cut to 2 layers, in
bfloat16 over a float32 master, as ``chip_smoke.py`` phase 16 serves it,
behind ``PersonalizedServeEngine`` with a ν snapshot whose deltas' RMS is
5% of the base's: four slots of four clients, two warm steps, then one
decode tick profiled on the "none" engine (the shared path) and one on
the "nu" engine (the row path).

Prints one JSON line each: host wall time, the device's busy time (the
union of kernel intervals) and idle share, kernel launches, the device
time of the flash-attention and SSD scan kernels, and the kernels by
device time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
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
from repro_torch.core import flat
from repro_torch.models.model import (init_caches, init_params,
                                      serve_decode, serve_prefill)
from repro_torch.roofline.round_profile import _busy_us
from repro_torch.serving import (PersonalizedServeEngine, Request,
                                 ServeEngine, make_snapshot)

SLOTS, MAX_LEN, BUCKETS = 4, 512, (32, 64, 128, 256)
HYBRID_ROWS, HYBRID_PROMPT = 4, 128
# output key: a fragment of the kernel names whose device time it sums
KERNELS = {"flash_attention_ms": "flash_fwd_kernel",
           "ssd_scan_ms": "ssd_scan_kernel"}


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
            **{key: sum(t for k, (_, t) in by_name.items()
                        if frag in k) / 1e3 for key, frag in KERNELS.items()},
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
    return _tagged([_profiled("admit_240_tokens", eng._admit, dev, top),
                    _profiled("decode_tick_4_slots", eng._tick, dev, top)],
                   cfg, dev)


def profile_hybrid(cfg: ModelConfig, device: str = "cuda",
                   top: int = 10) -> list[dict]:
    dev = torch.device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (HYBRID_ROWS, HYBRID_PROMPT))).to(dev)
    state = {}

    def prefill():
        caches = init_caches(cfg, HYBRID_ROWS, MAX_LEN, device=dev)
        state["logits"], state["caches"] = serve_prefill(
            params, {"tokens": prompt}, cfg, caches=caches)
        state["pos"] = HYBRID_PROMPT

    def step():
        tok = state["logits"][:, -1].argmax(-1)[:, None]
        state["logits"], state["caches"] = serve_decode(
            params, {"tokens": tok}, state["caches"], state["pos"], cfg)
        state["pos"] += 1

    with torch.inference_mode():
        prefill()
        step()
        step()
    return _tagged(
        [_profiled(f"prefill_{HYBRID_ROWS}x{HYBRID_PROMPT}_tokens", prefill,
                   dev, top),
         _profiled(f"decode_step_{HYBRID_ROWS}_rows", step, dev, top)],
        cfg, dev)


def profile_personalized(cfg: ModelConfig, device: str = "cuda",
                         top: int = 10) -> list[dict]:
    dev = torch.device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    spec = flat.make_flat_spec(params, master_dtype="float32")
    base = flat.ravel(spec, params)
    del params
    gen = torch.Generator(device=dev).manual_seed(1)
    nu_i = torch.randn((SLOTS, spec.p), generator=gen, device=dev)
    nu_i *= 0.05 * float(base[:spec.n].norm()) / spec.n ** 0.5
    nu_i[:, spec.n:] = 0
    snap = make_snapshot(0, base, nu=torch.zeros_like(base), nu_i=nu_i)
    rng = np.random.default_rng(0)
    rows = []
    for kind in ("none", "nu"):
        eng = PersonalizedServeEngine(cfg, spec, snap, personalizer=kind,
                                      slots=SLOTS, max_len=MAX_LEN,
                                      prefill_buckets=BUCKETS, device=dev)
        for uid, n in enumerate((200, 100, 50, 120)):
            eng.submit(Request(uid=uid, max_new_tokens=64, client_id=uid,
                               prompt=rng.integers(1, cfg.vocab, n).astype(
                                   np.int32)))
        eng.step()
        eng.step()
        rows.append(_profiled(f"{kind}_decode_tick_{SLOTS}_slots",
                              eng._tick, dev, top))
        del eng
    return _tagged(rows, cfg, dev)


def _tagged(rows: list[dict], cfg: ModelConfig,
            dev: torch.device) -> list[dict]:
    for row in rows:
        row.update(model=cfg.name, dtype=cfg.dtype, n_layers=cfg.n_layers,
                   device=(torch.cuda.get_device_name(0)
                           if dev.type == "cuda" else "cpu"))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--arch", default="llama3-8b",
                       help="the model behind the engine profile "
                            "(default llama3-8b)")
    which.add_argument("--hybrid", action="store_true",
                       help="profile zamba2-2.7b's serve_prefill / "
                            "serve_decode instead of llama3-8b's engine")
    which.add_argument("--personalized", action="store_true",
                       help="profile a shared and a row-path tick of the "
                            "personalized engine on 2-layer gemma-2b")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.personalized:
        cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=2,
                                  dtype="bfloat16")
        rows = profile_personalized(cfg)
    else:
        name, fn = (("zamba2-2.7b", profile_hybrid) if args.hybrid
                    else (args.arch, profile_serving))
        rows = fn(dataclasses.replace(get_arch(name), dtype="bfloat16"))
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
