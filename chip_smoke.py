#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Three phases, each printing one JSON line; any failure exits non-zero.

1. env/build — the card, its power limit, the torch and CUDA versions; TF32
   off for matmuls and convolutions; the CUDA kernels built with nvcc from
   the sources in this checkout.
2. kernels — every kernel of the main path against its plain PyTorch
   version on the card (float32 and bfloat16, the main path's shapes, ragged
   row counts and one large shape), and its time beside the plain version's
   and the least time the card could take (``bound_ms``).
3. main path — ``FederatedSimulation.run(5, eval_every=5)`` at the full
   width of the paper's non-convex task (mlp 60-64-10, batch 20, FedProx
   synthetic(1,1), 10 clients, the bimodal K schedule: nine clients at
   K = 2, one at K = 200; lr 0.03, λ = 1) for fedavg, fedprox, fednova and
   fedagrac.  Every local step must go through a kernel (launch counters),
   and the trajectory must match the same run on the CPU.

Then a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
LR, LAM, MU = 0.03, 0.7, 0.1
MAIN_SHAPES = {"lr": (10, 640), "mlp": (10, 4608)}
CHECK_SHAPES = [(10, 640), (10, 4608), (3, 128), (1000, 384), (65536, 1024)]
TIMED_SHAPES = [(10, 640), (10, 4608), (65536, 1024)]
# the kernel does the plain version's float32 arithmetic, one rounding per
# operation in the same order, so both agree to the last bit; the stated
# tolerance (as in tests/test_kernels.py) leaves room for one ulp
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8}
# The main path on the card against the same run on the CPU.  Both see the
# same data, batches and initial weights and differ only in float32
# rounding (cuBLAS and the CPU's BLAS sum in other orders).  How far
# rounding alone moves this trajectory is measured, not assumed: a second
# CPU run takes every microbatch with its rows reversed — the same loss (a
# mean over the rows) with other roundings — and the card must stay within
# PATH_SPREAD times that spread, plus a float32-scale floor (PATH_RTOL
# relative; PATH_SAMPLES of the 4000 eval samples, for logits that tie to
# within rounding).  On a contractive run the spread is float32 noise and
# the check is tight; a run that amplifies rounding has a wide spread, in
# the JAX package as here, and the check says so instead of failing on it.
PATH_SPREAD, PATH_RTOL, PATH_SAMPLES = 4.0, 1e-4, 4


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, iters: int) -> float:
    """Device time per call over ``iters`` back-to-back calls (CUDA
    events), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in _build.SOURCES
             for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    env = {"phase": "env", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "python": sys.version.split()[0], "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "nvcc_build_s": build_s, "built": sorted(built), "ptxas": ptxas}
    _emit(env)
    return env


def _operands(shape, dtype, gen):
    rows, cols = shape
    dev = DEVICE
    x, g, c, x0 = (torch.randn(rows, cols, generator=gen, device=dev
                               ).to(dtype) for _ in range(4))
    active = torch.arange(rows, device=dev) % 3 != 1
    eta = torch.where(active, LR, 0.0).to(torch.float32)
    return x, g, c, x0, eta, active


def _bound(inputs, out, ops_per_elem) -> tuple[float, str]:
    nbytes = sum(t.numel() * t.element_size() for t in inputs) \
        + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = out.numel() * ops_per_elem / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels() -> dict:
    from repro_torch.kernels.calibrated_update import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # (wrapper, plain version, operands for it, float32 ops per element);
    # the timed forms are the main path's: fedagrac passes c, fedprox none
    entries = {
        "calibrated_update": (
            ops.calibrated_update, ref.calibrated_update,
            lambda x, g, c, x0, eta: (x, g, c, eta, LAM), 4),
        "calibrated_update_prox": (
            ops.calibrated_update_prox, ref.calibrated_update_prox,
            lambda x, g, c, x0, eta: (x, g, None, x0, eta, 0.0, MU), 5),
    }
    result = {name: {"max_abs_err": 0.0} for name in entries}
    checks = []
    for name, (kernel, plain, args_of, n_ops) in entries.items():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in CHECK_SHAPES:
                x, g, c, x0, eta, active = _operands(shape, dtype, gen)
                forms = [args_of(x, g, c, x0, eta)]
                if name == "calibrated_update":
                    forms.append((x, g, None, eta, 0.0))
                else:
                    forms.append((x, g, c, x0, eta, LAM, MU))
                for args in forms:
                    got = kernel(*args)
                    want = plain(*args)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs()
                    tol = KERNEL_TOL[dtype] * (1 + want.float().abs())
                    max_err = float(err.max())
                    _require(bool((err <= tol).all()),
                             f"{name} {dtype} {shape}: max |err| {max_err}")
                    _require(torch.equal(got[~active], x[~active]),
                             f"{name} {dtype} {shape}: an η = 0 row moved")
                    result[name]["max_abs_err"] = max(
                        result[name]["max_abs_err"], max_err)
                    checks.append({"kernel": name, "dtype": str(dtype),
                                   "shape": shape,
                                   "c": args[2] is not None,
                                   "max_abs_err": max_err,
                                   "tol": KERNEL_TOL[dtype]})
                if shape not in TIMED_SHAPES:
                    continue
                args = args_of(x, g, c, x0, eta)
                big = shape[0] * shape[1] > 1 << 20
                iters = 20 if big else 500
                out = kernel(*args)
                inputs = [a for a in args if isinstance(a, torch.Tensor)]
                bound_ms, bound_by = _bound(inputs, out, n_ops)
                timing = {"kernel": name, "dtype": str(dtype),
                          "shape": shape,
                          "ms": _time_ms(lambda: kernel(*args), iters),
                          "plain_ms": _time_ms(lambda: plain(*args), iters),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None}
                _emit({"phase": "kernel_time", **timing})
                if dtype == torch.float32 and shape == MAIN_SHAPES["mlp"]:
                    result[name].update(
                        {k: timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")})
                del x, g, c, x0, eta, out
                torch.cuda.empty_cache()
    _emit({"phase": "kernels", "checks": len(checks),
           "max_abs_err": {n: r["max_abs_err"] for n, r in result.items()},
           "worst": max(checks, key=lambda ch: ch["max_abs_err"])})
    return result


def _reverse_rows(batches: dict) -> dict:
    return {"x": batches["x"].flip(-2), "y": batches["y"].flip(-1)}


def _run_main_path(device: str, algorithms, data, parts, params0,
                   reverse_rows: bool = False) -> dict:
    from repro_torch.configs.base import FedConfig
    from repro_torch.data import FederatedBatcher
    from repro_torch.fed import FederatedSimulation
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.models.simple import mlp_accuracy, mlp_loss

    class Batcher(FederatedBatcher):
        def round_batches(self, t, k_max):
            b = super().round_batches(t, k_max)
            return _reverse_rows(b) if reverse_rows else b

        def chunk_batches(self, t0, r, k_max):
            b = super().chunk_batches(t0, r, k_max)
            return _reverse_rows(b) if reverse_rows else b

    x_eval, y_eval = data.x.to(device), data.y.to(device)
    ks = np.full((1, 10), 2, np.int32)
    ks[0, -1] = 200
    out = {}
    for algo in algorithms:
        fed = FedConfig(algorithm=algo, n_clients=10, lr=0.03,
                        calibration_rate=1.0, weights="data",
                        param_layout="flat")
        batcher = Batcher(data, parts, batch_size=20, seed=0, device=device)
        sim = FederatedSimulation(
            mlp_loss, params0, fed, batcher, k_schedule=ks, device=device,
            eval_fn=lambda p: float(mlp_accuracy(p, {"x": x_eval,
                                                     "y": y_eval})))
        before = dict(ops.launches)
        hist = sim.run(5, eval_every=5)
        out[algo] = {
            "loss": np.array(hist.loss), "metric": np.array(hist.metric),
            "wall_per_round_s": float(np.mean(hist.wall)),
            "params": sim.state["params"].cpu(),
            "launches": {k: ops.launches[k] - before[k] for k in before}}
    return out


def phase_main_path() -> dict:
    from repro_torch.data import fedprox_synthetic
    from repro_torch.kernels.calibrated_update import ops
    from repro_torch.models.simple import mlp_init
    algorithms = ("fedavg", "fedprox", "fednova", "fedagrac")
    data, parts = fedprox_synthetic(0, 10, alpha=1.0, beta=1.0)
    params0 = mlp_init(torch.Generator().manual_seed(0), 60, 64, 10)
    # warm-up (cuBLAS handles, allocator) outside the counted run
    _run_main_path(DEVICE, ("fedavg",), data, parts, params0)
    ops.reset_launches()
    gpu = _run_main_path(DEVICE, algorithms, data, parts, params0)
    launches = dict(ops.launches)
    cpu = _run_main_path("cpu", algorithms, data, parts, params0)
    spread = _run_main_path("cpu", algorithms, data, parts, params0,
                            reverse_rows=True)
    for name, n in launches.items():
        _require(n > 0, f"{name} was never launched on the main path")
    for algo in algorithms:
        g, c, p = gpu[algo], cpu[algo], spread[algo]
        kernel = ("calibrated_update_prox" if algo == "fedprox"
                  else "calibrated_update")
        _require(g["launches"][kernel] == 5 * 200,
                 f"{algo}: {g['launches']} launches, expected 1000 of "
                 f"{kernel} (5 rounds × k_max 200)")
        _require(np.isfinite(g["loss"]).all()
                 and np.isfinite(g["metric"]).all(),
                 f"{algo}: non-finite loss or metric")
        vs = {"loss": (np.abs(g["loss"] - c["loss"]),
                       PATH_SPREAD * np.abs(p["loss"] - c["loss"])
                       + PATH_RTOL * np.abs(c["loss"])),
              "metric_samples": (
                  4000 * np.abs(g["metric"] - c["metric"]),
                  PATH_SPREAD * 4000 * np.abs(p["metric"] - c["metric"])
                  + PATH_SAMPLES),
              "params": (
                  float((g["params"] - c["params"]).abs().max()),
                  PATH_SPREAD * float((p["params"] - c["params"]).abs().max())
                  + PATH_RTOL * float(c["params"].abs().max()))}
        for what, (diff, tol) in vs.items():
            _require(bool(np.all(diff <= tol)),
                     f"{algo}: {what} differs from the CPU run by {diff}, "
                     f"more than {tol}")
        _emit({"phase": "main_path", "algorithm": algo,
               "loss": g["loss"].tolist(), "metric": g["metric"].tolist(),
               "wall_per_round_s": g["wall_per_round_s"],
               "cpu_wall_per_round_s": c["wall_per_round_s"],
               "launches": g["launches"],
               "vs_cpu": {k: float(np.max(d)) for k, (d, _) in vs.items()},
               "tol": {k: float(np.min(t)) for k, (_, t) in vs.items()}})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    phase_env()
    timings = phase_kernels()
    launches = phase_main_path()
    sources = {"calibrated_update": (
        "src/repro_torch/kernels/calibrated_update/csrc/calibrated_update.cu",
        "src/repro/kernels/calibrated_update/kernel.py:60"),
        "calibrated_update_prox": (
        "src/repro_torch/kernels/calibrated_update/csrc/calibrated_update.cu",
        "src/repro/kernels/calibrated_update/kernel.py:83")}
    _emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **timings[name]}
        for name, (src, rep) in sources.items()]})
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
