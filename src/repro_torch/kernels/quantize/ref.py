"""Plain PyTorch versions of the wire-compression kernels, on ``(rows,
128·k)`` matrices with one float32 scalar per row (a ``(rows, 1)``
operand):

    quantize_2d:    q = int8(clip(round(x / s), −qmax, qmax))
    dequantize_2d:  x̂ = q · s, cast to ``out_dtype``
    topk_mask_2d:   x̂ = x · 1[|x| ≥ t], cast back to ``x.dtype``

The arithmetic of ``src/repro/kernels/quantize/ref.py`` in the same order:
float32 inside, ``torch.round`` rounding half to even like ``jnp.round``,
a true division ``x / s`` (not a product with ``1/s``), the clip in
float32 and the cast to int8 after it.  The CUDA kernels in
``csrc/quantize.cu`` do the same operations, and ``chip_smoke.py`` holds
them to these results exactly on the card.
"""
from __future__ import annotations

import torch


def quantize_2d(x: torch.Tensor, scale: torch.Tensor,
                qmax: int = 127) -> torch.Tensor:
    q = torch.clamp(torch.round(x.float() / scale.float()),
                    -float(qmax), float(qmax))
    return q.to(torch.int8)


def dequantize_2d(q: torch.Tensor, scale: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(out_dtype)


def topk_mask_2d(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.where(xf.abs() >= thresh.float(), xf, 0.0).to(x.dtype)
