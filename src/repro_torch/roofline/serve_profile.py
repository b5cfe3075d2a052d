"""Where the serving paths spend their time on the card.

    PYTHONPATH=src python -m repro_torch.roofline.serve_profile \
        [--arch NAME | --hybrid | --personalized | --launch]

Without ``--hybrid``: builds llama3-8b (or ``--arch``: any model the
engine serves, e.g. deepseek-v2-lite-16b, granite-moe-1b-a400m or
gemma3-12b, as ``chip_smoke.py`` phase 19 serves them; a model the engine
refuses — xlstm-125m, musicgen-medium, qwen2-vl-2b — takes the
``--hybrid`` profile below at 4 prompts of 512 tokens, as phase 20 serves
them) at full width and
depth in bfloat16 (random weights from a seed) behind a ``ServeEngine``
with 4 slots, max_len 512 and buckets (32, 64, 128, 256), as
``chip_smoke.py`` phase 6 does; fills three slots and runs two warm
steps, then profiles with ``torch.profiler`` one admission of a 240-token
prompt (bucket 256) into the free slot and one decode tick of the four
live slots.

With ``--hybrid``: builds zamba2-2.7b at full width and depth in bfloat16,
as ``chip_smoke.py`` phase 10 does; after a warm prefill and two decode
steps, profiles one ``serve_prefill`` of 4 prompts of 128 tokens and one
``serve_decode`` step of those 4 rows.  The engine's refused models take
the same profile with their own batches (``prompt_batch``): musicgen's
codes (B, K, S), each step feeding back every codebook's argmax;
qwen2-vl's seeded embeddings behind an image grid of positions, each step
feeding back ``embed[token]`` at the next text position.

With ``--personalized``: gemma-2b at full width, cut to 2 layers, in
bfloat16 over a float32 master, as ``chip_smoke.py`` phase 16 serves it,
behind ``PersonalizedServeEngine`` with a ν snapshot whose deltas' RMS is
5% of the base's: four slots of four clients, two warm steps, then one
decode tick profiled on the "none" engine (the shared path) and one on
the "nu" engine (the row path).

With ``--launch``: qwen1.5-32b uncut in bfloat16 through the launch
layer's ``build_prefill`` / ``build_decode`` on a ``(1, 1)`` mesh of a
one-rank group, as ``chip_smoke.py`` phase 22 serves it (4 × 512 into
caches of 1024 slots); after a warm prefill and two steps, profiles one
prefill and one decode step, then the same decode step on the plain
tensors under the mesh's DTensors (``serve_decode``, no mesh), and one
more mesh step under ``cProfile``, whose host seconds it sums by where
the Python runs: DTensor (``torch/distributed/tensor``), the port
(``repro_torch``), the rest.

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
DIRECT_PROMPT = 512     # the refused models' prompts (4 rows, phase 20's)
IMAGE_GRID = 16         # a vision prompt opens with a 16 × 16 patch grid
# output key: a fragment of the kernel names whose device time it sums
KERNELS = {"flash_attention_ms": "flash_fwd_kernel",
           "ssd_scan_ms": "ssd_scan_kernel"}


def _profiled(name: str, fn, device: torch.device, top: int,
              grad_mode=torch.inference_mode) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        with grad_mode():
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


def prompt_batch(cfg: ModelConfig, rows: int, length: int, device,
                 seed: int = 0, grid: int = IMAGE_GRID) -> dict:
    """A seeded prompt batch of ``rows`` × ``length`` for ``cfg``'s front
    end: token ids (B, S); audio codes (B, K, S); or vision embeddings
    (B, S, d), N(0, 1), with M-RoPE positions (B, 3, S): a ``grid`` ×
    ``grid`` image first, patch i at (0, i // grid, i % grid), then text
    numbered on all three axes from one past the grid's largest id, as
    Qwen2-VL numbers text after an image."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        codes = rng.integers(0, cfg.vocab, (rows, cfg.n_codebooks, length))
        return {"codes": torch.from_numpy(codes).to(device)}
    if cfg.frontend == "vision":
        assert grid * grid < length, (grid, length)
        i = np.arange(grid * grid)
        text = grid + np.arange(length - grid * grid)
        pos = np.concatenate([np.stack([0 * i, i // grid, i % grid]),
                              np.stack([text] * 3)], axis=1)
        embeds = rng.standard_normal((rows, length, cfg.d_model),
                                     dtype=np.float32)
        return {"embeds": torch.from_numpy(embeds).to(device),
                "positions": torch.from_numpy(np.broadcast_to(
                    pos, (rows, 3, length)).copy()).to(device)}
    return {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab, (rows, length))).to(device)}


def step_batch(cfg: ModelConfig, params, tokens: torch.Tensor,
               position) -> dict:
    """The one-position batch feeding back ``tokens``, the last position's
    argmax (B,) — (B, K) from the audio head: codes (B, K, 1);
    ``embed[token]`` at M-RoPE position ``position`` on all three axes
    (vision); else token ids (B, 1)."""
    if cfg.frontend == "audio":
        return {"codes": tokens[:, :, None]}
    if cfg.frontend == "vision":
        B = tokens.shape[0]
        return {"embeds": params["embed"][tokens][:, None],
                "positions": torch.full((B, 3, 1), int(position),
                                        dtype=torch.long,
                                        device=tokens.device)}
    return {"tokens": tokens[:, None]}


def next_position(batch: dict) -> int:
    """The M-RoPE id of the first text token after a vision prompt."""
    return int(batch["positions"].max()) + 1


def profile_hybrid(cfg: ModelConfig, device: str = "cuda", top: int = 10,
                   length: int = HYBRID_PROMPT) -> list[dict]:
    dev = torch.device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = prompt_batch(cfg, HYBRID_ROWS, length, dev)
    mrope = next_position(prompt) if cfg.frontend == "vision" else 0
    state = {}

    def prefill():
        caches = init_caches(cfg, HYBRID_ROWS, max(MAX_LEN, length + 16),
                             device=dev)
        state["logits"], state["caches"] = serve_prefill(
            params, prompt, cfg, caches=caches)
        state["pos"] = length

    def step():
        batch = step_batch(cfg, params, state["logits"][:, -1].argmax(-1),
                           mrope + state["pos"] - length)
        state["logits"], state["caches"] = serve_decode(
            params, batch, state["caches"], state["pos"], cfg)
        state["pos"] += 1

    with torch.inference_mode():
        prefill()
        step()
        step()
    return _tagged(
        [_profiled(f"prefill_{HYBRID_ROWS}x{length}_tokens", prefill,
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


LAUNCH_ARCH, LAUNCH_CACHE = "qwen1.5-32b", 1024


def _host_split(fn, device: torch.device) -> dict:
    """Host seconds of one call of ``fn`` under ``cProfile``, summed by
    where each function's own time was spent."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    with torch.no_grad():
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    groups = defaultdict(float)
    for (path, _line, _fn), (_cc, _nc, tt, _ct, _callers) in \
            pstats.Stats(prof).stats.items():
        key = ("dtensor_s" if "torch/distributed/tensor" in path
               else "port_s" if "repro_torch" in path else "other_s")
        groups[key] += tt
    return {"step": "launch_decode_cprofile", **dict(groups),
            "total_s": sum(groups.values())}


def profile_launch(cfg: ModelConfig, device: str = "cuda", top: int = 10,
                   length: int = DIRECT_PROMPT) -> list[dict]:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device(device)
    mesh = make_local_mesh(1, 1, device_type=dev.type)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rows = HYBRID_ROWS
    prefill_step, bundle = serve.build_prefill(
        cfg, ShapeConfig("prefill", LAUNCH_CACHE, rows, "prefill"), mesh)
    decode_step, _ = serve.build_decode(
        cfg, ShapeConfig("decode", LAUNCH_CACHE, rows, "decode"), mesh)
    placed = serve.place(params, bundle["param_ps"], mesh)
    tokens = prompt_batch(cfg, rows, length, dev)["tokens"]
    state = {}

    def prefill():
        state["logits"], state["caches"] = prefill_step(
            placed, {"tokens": tokens},
            init_caches(cfg, rows, LAUNCH_CACHE, device=dev))
        state["pos"] = length

    def step():
        tok = state["logits"].full_tensor()[:, -1].argmax(-1)
        state["logits"], state["caches"] = decode_step(
            placed, {"tokens": tok[:, None]}, state["caches"], state["pos"])
        state["pos"] += 1

    def plain_step():
        caches = [{k: t.to_local() for k, t in c.items()}
                  for c in state["caches"]]
        tok = state["logits"].full_tensor()[:, -1].argmax(-1)
        serve_decode(params, {"tokens": tok[:, None]}, caches, state["pos"],
                     cfg, donate=True)

    prefill()
    step()
    step()
    out = [_profiled(f"launch_prefill_{rows}x{length}_tokens", prefill, dev,
                     top, torch.no_grad)]
    step()
    out.append(_profiled(f"launch_decode_step_{rows}_rows", step, dev, top,
                         torch.no_grad))
    plain_step()
    out.append(_profiled(f"plain_decode_step_{rows}_rows", plain_step, dev,
                         top, torch.no_grad))
    out.append(_host_split(step, dev))
    return _tagged(out, cfg, dev)


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
                            "serve_decode instead of llama3-8b's engine "
                            "(xlstm-125m, musicgen-medium and qwen2-vl-2b "
                            "take this profile under --arch)")
    which.add_argument("--personalized", action="store_true",
                       help="profile a shared and a row-path tick of the "
                            "personalized engine on 2-layer gemma-2b")
    which.add_argument("--launch", action="store_true",
                       help="profile qwen1.5-32b's prefill and decode "
                            "step through the launch layer on a (1, 1) "
                            "mesh, beside a plain decode step")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.personalized:
        cfg = dataclasses.replace(get_arch("gemma-2b"), n_layers=2,
                                  dtype="bfloat16")
        rows = profile_personalized(cfg)
    elif args.launch:
        rows = profile_launch(dataclasses.replace(get_arch(LAUNCH_ARCH),
                                                  dtype="bfloat16"))
    else:
        cfg = dataclasses.replace(
            get_arch("zamba2-2.7b" if args.hybrid else args.arch),
            dtype="bfloat16")
        if args.hybrid:
            rows = profile_hybrid(cfg)
        elif (cfg.frontend != "none" or cfg.ssm is not None
              or cfg.xlstm is not None):
            # the models the engine refuses: the direct serve_prefill /
            # serve_decode profile at phase 20's prompts
            rows = profile_hybrid(cfg, length=DIRECT_PROMPT)
        else:
            rows = profile_serving(cfg)
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
