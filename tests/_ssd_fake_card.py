"""A fake card for the SSD wrappers' tests (``test_torch_ssd_scan.py``,
``test_torch_mamba.py``): ``ops._on_cpu`` answers False, and each launch
function of ``repro_torch.kernels.ssd_scan.ops`` becomes a counting
wrapper of the plain version of what its kernel computes — the forward
with the states entering each chunk (``ref.chunk_states``), ``ref.bwd_*``
for the four backward kernels — while the CPU route (``ref.ssd_chunked``,
``ref.ssd_chunked_bwd``) raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.ssd_scan import ops, ref

# each launch function's argument shaped as x (dy for dstate) and its A
# (None: it takes none)
X_AT = {"ssd_scan": 0, "ssd_bwd_dstate": 3, "ssd_bwd_chain": 0,
        "ssd_bwd_chunk": 0, "ssd_bwd_reduce": 0}
A_AT = {"ssd_scan": 2, "ssd_bwd_dstate": 1, "ssd_bwd_chain": None,
        "ssd_bwd_chunk": 2, "ssd_bwd_reduce": None}


class Launch(NamedTuple):
    shapes: tuple                 # every tensor argument's shape, in order
    x: tuple                      # the shape of the argument shaped as x
    a: Optional[tuple]            # A's shape, and its batch stride as the
    a_stride: Optional[int]       # kernel gets it


def plain_card(monkeypatch) -> dict:
    """Install the fake card and zero the launch counters; returns
    {launch: [Launch of each call]}."""
    seen = {name: [] for name in ops.launches}

    def refuse(*args, **kw):
        raise AssertionError("the card reached the CPU route")

    def counting(name, plain):
        def launch(*args, **kw):
            a = None if A_AT[name] is None else args[A_AT[name]]
            seen[name].append(Launch(
                tuple(tuple(t.shape) for t in args
                      if isinstance(t, torch.Tensor)),
                tuple(args[X_AT[name]].shape),
                None if a is None else tuple(a.shape),
                None if a is None else ops._a_stride(a)))
            ops.launches[name] += 1
            return plain(*args, **kw)
        return launch

    def forward(x, dt, A, B, C, L, states):
        y, state, entering = ref.chunk_states(x, dt, A, B, C, L)
        return y, state, entering if states else None

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_launch", counting("ssd_scan", forward))
    for stage in ("dstate", "chain", "chunk", "reduce"):
        monkeypatch.setattr(ops, f"_launch_{stage}", counting(
            f"ssd_bwd_{stage}", getattr(ref, f"bwd_{stage}")))
    monkeypatch.setattr(ref, "ssd_chunked", refuse)
    monkeypatch.setattr(ref, "ssd_chunked_bwd", refuse)
    ops.reset_launches()
    return seen
