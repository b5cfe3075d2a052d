"""The SSD forward kernel's device time at the training path's shape, for
two checkouts of the port side by side on one card.

    PYTHONPATH=src python -m repro_torch.roofline.ssd_forward_time \
        [--against OTHER/src] [--rounds 3]

Times ``ops.ssd_scan`` — inference, no states kept, one A (h,) — at
``chip_smoke.py``'s SSD_PATH_SHAPE (4 rows of 256, 80 heads of dim 64, one
group of d_state 64, chunk 128; x, B and C slices of one conv output) in
bfloat16 and float32, by CUDA-graph replay (SAMPLES replays of ITERS
calls each, the median and the spread printed).  Each measurement runs in
a process of its own whose ``PYTHONPATH`` is the checkout's ``src``; with
``--against``, the other checkout's and this one's alternate, ``other,
this, this, other`` for each round, so a drift of the card's clocks over
the call falls on both alike.  Each process also prints ``nvcc``'s
register and spill lines of the kernel's instances from its build log.
Prints one JSON line per process, then a summary line.  Needs a CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's SSD_PATH_SHAPE: (b, l, h, p, g, n, chunk)
SHAPE = (4, 256, 80, 64, 1, 64, 128)
ITERS, SAMPLES = 50, 7
SRC = Path(__file__).resolve().parents[2]


def _ptxas(log: str) -> dict:
    """Registers and spill bytes of each SSD forward instance in an
    ``-Xptxas -v`` log, by mangled name."""
    table, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
            fn = fn if "ssd_scan_kernel_mma" in fn else None
        elif fn and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            table[fn] = {"spill_stores": int(m[1]), "spill_loads": int(m[2])}
        elif fn and "registers" in ln:
            table[fn]["registers"] = int(
                re.search(r"Used (\d+) registers", ln)[1])
    return table


def _child() -> dict:
    """Time the forward of the ``repro_torch`` on ``sys.path``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops

    b, l, h, p, g, n, chunk = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    row = {"package": str(Path(ops.__file__).resolve().parents[3]),
           "shape": SHAPE, "device": torch.cuda.get_device_name(0)}
    for dtype in (torch.bfloat16, torch.float32):
        d_in = h * p
        xbc = torch.randn(b, l, d_in + 2 * g * n, generator=gen,
                          device=dev).to(dtype)
        x = xbc[..., :d_in].reshape(b, l, h, p)
        B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
        C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
        dt = torch.nn.functional.softplus(
            torch.randn(b, l, h, generator=gen, device=dev))
        A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=dev))

        def call():
            ops.ssd_scan(x, dt, A, B, C, chunk)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(ITERS):
                call()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(SAMPLES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / ITERS)
        row[str(dtype).removeprefix("torch.")] = {
            "median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}
        del graph
    row["ptxas"] = _ptxas(_build.build_log("ssd_scan"))
    return row


def _run(src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--child"], env=env, capture_output=True,
                         text=True, check=True)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's src directory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child()), flush=True)
        return
    this = SRC
    order = ([args.against, this, this, args.against] * args.rounds
             if args.against is not None else [this] * args.rounds)
    rows = {}
    for src in order:
        rows.setdefault(str(src.resolve()), []).append(_run(src))
    summary = {}
    for src, runs in rows.items():
        summary[src] = {
            dtype: {"medians_ms": [r[dtype]["median_ms"] for r in runs],
                    "min_ms": min(r[dtype]["min_ms"] for r in runs),
                    "max_ms": max(r[dtype]["max_ms"] for r in runs)}
            for dtype in ("bfloat16", "float32")}
    print(json.dumps({"summary": summary, "order": [str(s) for s in order]}),
          flush=True)


if __name__ == "__main__":
    main()
