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

The harness (``main``, ``graph_times``, ``operands``, ``ptxas``) also
serves ``ssd_backward_time``.  A child process runs this checkout's script
with the other checkout's package on its path, so the child side uses
nothing of ``repro_torch`` but the kernels.
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
from typing import Callable

# chip_smoke.py's SSD_PATH_SHAPE: (b, l, h, p, g, n, chunk)
SHAPE = (4, 256, 80, 64, 1, 64, 128)
ITERS, SAMPLES = 50, 7
SRC = Path(__file__).resolve().parents[2]


def ptxas(log: str, kernel: str) -> dict:
    """Registers and spill bytes of each instance of ``kernel`` (a part of
    its mangled name) in an ``-Xptxas -v`` log, by mangled name."""
    table, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("Function properties for")[-1].strip()
            fn = fn if kernel in fn else None
        elif fn and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            table[fn] = {"spill_stores": int(m[1]), "spill_loads": int(m[2])}
        elif fn and "registers" in ln:
            table[fn]["registers"] = int(
                re.search(r"Used (\d+) registers", ln)[1])
    return table


def operands(dtype, gen, a_rows: bool = False):
    """x, dt, A, B, C at SHAPE on the card, as the Mamba2 block hands them
    over: x, B and C slices of one conv output in ``dtype``, dt and A
    float32; A (b, h) with ``a_rows`` (the training path's folded
    clients), else (h,)."""
    import torch

    b, l, h, p, g, n, _ = SHAPE
    dev = torch.device("cuda")
    d_in = h * p
    xbc = torch.randn(b, l, d_in + 2 * g * n, generator=gen,
                      device=dev).to(dtype)
    x = xbc[..., :d_in].reshape(b, l, h, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((b, h) if a_rows else (h,),
                                     generator=gen, device=dev))
    return x, dt, A, B, C


def graph_times(call: Callable[[], object], iters: int = ITERS) -> dict:
    """``call``'s device time: ``iters`` calls captured in one CUDA graph
    (after a warm-up on a side stream), replayed SAMPLES times; the median,
    least and largest ms per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
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
        times.append(start.elapsed_time(end) / iters)
    del graph
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}


def _child() -> dict:
    """Time the forward of the ``repro_torch`` on ``sys.path``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops

    gen = torch.Generator(device="cuda").manual_seed(5)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, B, C = operands(dtype, gen)
        times[str(dtype).removeprefix("torch.")] = graph_times(
            lambda: ops.ssd_scan(x, dt, A, B, C, SHAPE[-1]))
    return {"times": times,
            "ptxas": ptxas(_build.build_log("ssd_scan"),
                           "ssd_scan_kernel_mma")}


def _run(script: Path, src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, str(script), "--child"], env=env,
                         capture_output=True, text=True, check=True)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(row), flush=True)
    return row


def main(argv=None, script: Path = Path(__file__).resolve(),
         child: Callable[[], dict] = _child, doc: str = __doc__) -> None:
    """The command line of ``script``: with ``--child`` print ``child()``
    (its ``times``: {label: graph_times}) with the package and the card;
    else run the children, alternating with ``--against``, and print a
    summary of each label's medians and spread by checkout."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout's src directory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        import torch

        from repro_torch.kernels import _build

        row = {"package": str(Path(_build.__file__).resolve().parents[2]),
               "shape": SHAPE, "device": torch.cuda.get_device_name(0),
               **child()}
        print(json.dumps(row), flush=True)
        return
    this = SRC
    order = ([args.against, this, this, args.against] * args.rounds
             if args.against is not None else [this] * args.rounds)
    rows = {}
    for src in order:
        rows.setdefault(str(src.resolve()), []).append(_run(script, src))
    summary = {}
    for src, runs in rows.items():
        summary[src] = {
            label: {"medians_ms": [r["times"][label]["median_ms"]
                                   for r in runs],
                    "min_ms": min(r["times"][label]["min_ms"] for r in runs),
                    "max_ms": max(r["times"][label]["max_ms"] for r in runs)}
            for label in runs[0]["times"]}
    print(json.dumps({"summary": summary, "order": [str(s) for s in order]}),
          flush=True)


if __name__ == "__main__":
    main()
