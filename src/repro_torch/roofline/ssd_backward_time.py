"""The SSD backward kernels' device time at the training path's shape, for
two checkouts of the port side by side on one card.

    PYTHONPATH=src python -m repro_torch.roofline.ssd_backward_time \
        [--against OTHER/src] [--rounds 3]

Times the four kernels of ``ssd_scan_bwd.cu`` one by one (``ops``'s
``_launch_dstate``, ``_launch_chain``, ``_launch_chunk``,
``_launch_reduce``) and the whole ``ops.ssd_scan_bwd`` at
``chip_smoke.py``'s SSD_PATH_SHAPE with one A per batch row, as phase 17
folds its two clients (4 rows of 256, 80 heads of dim 64, one group of
d_state 64, chunk 128; x, B and C slices of one conv output), the
cotangents dy and dS_last drawn from a seed, in bfloat16 and float32.
``ssd_forward_time``'s harness does the rest: CUDA-graph replay (the
median and spread of SAMPLES replays of ITERS calls), one process per
measurement with the checkout's ``src`` on ``PYTHONPATH``, ``other,
this, this, other`` for each round with ``--against``, and each
process's ``nvcc`` register and spill lines of the backward's dstate and
chunk instances.  Prints one JSON line per process, then a summary line.
Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path


def _harness():
    """This checkout's ``ssd_forward_time``, loaded from its file: in a
    child process the package on ``sys.path`` is the checkout being timed,
    which need not have the harness."""
    path = Path(__file__).resolve().with_name("ssd_forward_time.py")
    spec = importlib.util.spec_from_file_location("_ssd_time_harness", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


harness = _harness()


def _child() -> dict:
    """Time the backward of the ``repro_torch`` on ``sys.path``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ops

    chunk = harness.SHAPE[-1]
    gen = torch.Generator(device="cuda").manual_seed(9)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, A, B, C = harness.operands(dtype, gen, a_rows=True)
        _, state, states = ops.ssd_scan(x, dt, A, B, C, chunk, states=True)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        dS = torch.randn(state.shape, generator=gen, device="cuda")
        h, L = x.shape[2], min(chunk, x.shape[1])
        dG, decay = ops._launch_dstate(dt, A, C, dy, L, h)
        G = ops._launch_chain(dG.clone(), decay, dS)
        _, _, dBh, dCh, dA_chunks = ops._launch_chunk(
            x, dt, A, B, C, dy, states, state, G, L)
        calls = {
            "ssd_bwd_dstate": lambda: ops._launch_dstate(dt, A, C, dy, L, h),
            "ssd_bwd_chain": lambda: ops._launch_chain(dG, decay, dS),
            "ssd_bwd_chunk": lambda: ops._launch_chunk(
                x, dt, A, B, C, dy, states, state, G, L),
            "ssd_bwd_reduce": lambda: ops._launch_reduce(
                dBh, dCh, dA_chunks, B.shape[2], dtype, False),
            "ssd_scan_bwd": lambda: ops.ssd_scan_bwd(
                x, dt, A, B, C, chunk, dy, dS, states, state)}
        name = str(dtype).removeprefix("torch.")
        for kernel, call in calls.items():
            times[f"{kernel} {name}"] = harness.graph_times(call)
    log = _build.build_log("ssd_scan_bwd")
    return {"times": times,
            "ptxas": {**harness.ptxas(log, "ssd_bwd_dstate_kernel"),
                      **harness.ptxas(log, "ssd_bwd_chunk_kernel")}}


def main(argv=None) -> None:
    harness.main(argv, script=Path(__file__).resolve(), child=_child,
                 doc=__doc__)


if __name__ == "__main__":
    main()
