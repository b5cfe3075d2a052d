"""Plain PyTorch versions of the calibrated local update (Alg. 1, line 9):

    x ← x − η_row (g + λ c)                      c = ν − ν⁽ⁱ⁾
    x ← x − η_row (g + λ c + μ (x − x₀))         (FedProx variant)

with a per-row step size η_row ``(rows,)``: the round folds the K_i mask into
it (η = 0 on rows whose client has finished its local steps).  Arithmetic is
in float32, one rounding per operation in the order written, and the result
is cast back to ``x.dtype`` — the arithmetic of the CUDA kernels in
``csrc/calibrated_update.cu``, which are checked against these on the card.
``c=None`` stands for a zero correction (algorithms without ν).
"""
from __future__ import annotations

from typing import Optional

import torch


def _step(g: torch.Tensor, c: Optional[torch.Tensor],
          lam: float) -> torch.Tensor:
    t = g.float()
    if c is not None:
        t = t + lam * c.float()
    return t


def calibrated_update(x: torch.Tensor, g: torch.Tensor,
                      c: Optional[torch.Tensor], eta: torch.Tensor,
                      lam: float) -> torch.Tensor:
    xf = x.float()
    return (xf - eta[:, None] * _step(g, c, lam)).to(x.dtype)


def calibrated_update_prox(x: torch.Tensor, g: torch.Tensor,
                           c: Optional[torch.Tensor], x0: torch.Tensor,
                           eta: torch.Tensor, lam: float,
                           mu: float) -> torch.Tensor:
    xf = x.float()
    t = _step(g, c, lam) + mu * (xf - x0.float())
    return (xf - eta[:, None] * t).to(x.dtype)
