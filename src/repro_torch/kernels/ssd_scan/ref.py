"""Plain PyTorch version of the Mamba2 chunked SSD scan, the
``ssd_chunked`` of ``src/repro/models/mamba2.py`` (which the JAX package's
``ssd_scan/ref.py`` re-exports as its kernel's oracle), with the same
contract:

    x (b, l, h, p); dt (b, l, h) post-softplus; A (h,) negative;
    B, C (b, l, g, n), group ``h // (h / g)`` serving head ``h``.
    Returns y (b, l, h, p) float32 and the final state (b, h, p, n) float32.

``L = min(chunk, l)`` and ``l % L == 0``.  dt is folded into x in float32
and ``dA = dt·A``; inside a chunk ``y = ((C·Bᵀ) ∘ exp(segsum(dA)))·(x·dt)``
with ``segsum`` −inf above the diagonal (so those terms are exactly 0), each
chunk's own state is ``Σ_s (x·dt)_s ⊗ exp(cum_L − cum_s) B_s``, the states
are carried from chunk to chunk by a Python loop (the reference's
``lax.scan``), and ``exp(cum) ∘ (C·S_prevᵀ)`` adds the carried state.
``naive_ssd`` is the literal per-step recurrence the chunked form
refactors exactly (tests only).
"""
from __future__ import annotations

import torch


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) -> (..., L, L), entry [z, s] = Σ_{j=s+1..z} x_j on and
    below the diagonal, −inf above."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = min(chunk, l)
    assert l % L == 0, (l, L)
    c = l // L
    rep = h // g

    xb = (x.float() * dt.float()[..., None]).reshape(b, c, L, h, p)
    dA = (dt.float() * A.float()[None, None, :]).reshape(b, c, L, h)
    Bc = B.reshape(b, c, L, g, n).repeat_interleave(rep, dim=3).float()
    Cc = C.reshape(b, c, L, g, n).repeat_interleave(rep, dim=3).float()

    dA_t = dA.permute(0, 1, 3, 2)                             # (b,c,h,L)
    cum = torch.cumsum(dA_t, dim=-1)
    Lmat = torch.exp(_segsum(dA_t))                           # (b,c,h,L,L)

    # intra-chunk (diagonal blocks)
    CB = torch.einsum("bczhn,bcshn->bchzs", Cc, Bc)
    y_diag = torch.einsum("bchzs,bcshp->bczhp", CB * Lmat, xb)

    # per-chunk final states
    decay_end = torch.exp(cum[..., -1:] - cum)                # (b,c,h,L)
    S_chunk = torch.einsum("bcshn,bchs,bcshp->bchpn", Bc, decay_end, xb)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[..., -1])                     # (b,c,h)
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prevs = []
    for ci in range(c):
        prevs.append(S)
        S = S_chunk[:, ci] + chunk_decay[:, ci, :, None, None] * S
    S_prevs = torch.stack(prevs, dim=1)                       # (b,c,h,p,n)

    # inter-chunk (off-diagonal) contribution
    y_off = torch.einsum("bczhn,bchz,bchpn->bczhp", Cc, torch.exp(cum),
                         S_prevs)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, S


def naive_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The literal recurrence ``S_t = exp(dt_t A) S_{t−1} + dt_t x_t B_tᵀ``,
    ``y_t = S_t C_t``, one position at a time."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    xb = x.float() * dt.float()[..., None]
    decay = torch.exp(dt.float() * A.float()[None, None, :])  # (b,l,h)
    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        S = (decay[:, t][..., None, None] * S
             + torch.einsum("bhp,bhn->bhpn", xb[:, t], Bh[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1), S
