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
A may also be ``(b, h)``, one row per batch row (the vmapped training
path folds its clients into b, each with its own A).
``naive_ssd`` is the literal per-step recurrence the chunked form
refactors exactly (tests only).

``ssd_chunked_bwd`` is the explicit chunked VJP, in the four stages of the
backward kernels (``csrc/ssd_scan_bwd.cu``) and with their terms; per
(b, h) and chunk c, G_c the cotangent of the state leaving chunk c:

* ``bwd_dstate``: ΔG_c = Σ_z exp(cum_z) dy_z ⊗ C_z and the decay
  exp(cum_last);
* ``bwd_chain``: G_{C−1} = dS_last, G_{c−1} = exp(cum_last,c)·G_c + ΔG_c;
* ``bwd_chunk``: with E = exp(segsum) masked, W = (C·Bᵀ) ∘ E and
  V = (dy·xdtᵀ) ∘ E, w = exp(cum_last − cum), S_{c−1} the state entering
  the chunk: d(xdt) = Wᵀ·dy + w ∘ (B·G_cᵀ), the per-head dB = Vᵀ·C +
  w ∘ (xdt·G_c), dC = V·B + exp(cum) ∘ (dy·S_{c−1}), dcum_z =
  C_z·dC_z − xdt_z·d(xdt)_z (+ ⟨G_c, S_c⟩ at the chunk's last position),
  ddA its reverse cumsum, ddt = Σ_p d(xdt)·x + ddA·A, dx = d(xdt)·dt and
  the chunk's share of dA, Σ ddA·dt;
* ``bwd_reduce``: dB, dC summed over each group's heads, dA over the
  chunks (and the batch rows, for a shared A).
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


def _a_rows(A: torch.Tensor, b: int) -> torch.Tensor:
    """A as (b, h) float32: a (h,) A broadcast over the batch rows."""
    A = A.float()
    return A.expand(b, A.shape[-1]) if A.dim() == 1 else A


def chunk_states(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, final state, states)``: ``ssd_chunked``'s outputs and the
    state entering each chunk, ``(b, c, h, p, n)`` float32 (zero for the
    first), which the kernel's forward writes for the backward."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = min(chunk, l)
    assert l % L == 0, (l, L)
    c = l // L
    rep = h // g

    xb = (x.float() * dt.float()[..., None]).reshape(b, c, L, h, p)
    dA = (dt.float() * _a_rows(A, b)[:, None, :]).reshape(b, c, L, h)
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
    return y, S, S_prevs


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    y, S, _ = chunk_states(x, dt, A, B, C, chunk)
    return y, S


def _chunked(dt, A, L):
    """dt and dA = dt·A as (b, c, h, L), and their in-chunk cumsum."""
    b, l, h = dt.shape
    c = l // L
    dt_t = dt.float().reshape(b, c, L, h).permute(0, 1, 3, 2)
    dA_t = dt_t * _a_rows(A, b)[:, None, :, None]
    return dt_t, torch.cumsum(dA_t, dim=-1)


def _heads(t, c, L, rep):
    """B or C (b, l, g, n) as float32 (b, c, L, h, n), each group repeated
    over its heads."""
    b, _, g, n = t.shape
    return t.reshape(b, c, L, g, n).repeat_interleave(rep, dim=3).float()


def bwd_dstate(dt: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
               dy: torch.Tensor, L: int, h: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: ``(ΔG (b, c, h, p, n), decay (b, c, h))``, ΔG_c =
    Σ_z exp(cum_z) dy_z ⊗ C_z (from y's carried-state term) and decay_c =
    exp(cum_last,c), both float32."""
    b, l, _, p = dy.shape
    c = l // L
    _, cum = _chunked(dt, A, L)
    Cc = _heads(C, c, L, h // C.shape[2])
    dyc = dy.float().reshape(b, c, L, h, p)
    dG = torch.einsum("bchz,bczhp,bczhn->bchpn", torch.exp(cum), dyc, Cc)
    return dG, torch.exp(cum[..., -1])


def bwd_chain(dG: torch.Tensor, decay: torch.Tensor,
              dS_last: torch.Tensor) -> torch.Tensor:
    """Stage 2: G (b, c, h, p, n), G_c the cotangent of the state leaving
    chunk c: G_{C−1} = dS_last, G_{c−1} = decay_c·G_c + ΔG_c."""
    c = dG.shape[1]
    G = dS_last.float()
    out = [None] * c
    for ci in range(c - 1, -1, -1):
        out[ci] = G
        G = decay[:, ci, :, None, None] * G + dG[:, ci]
    return torch.stack(out, dim=1)


def bwd_chunk(x, dt, A, B, C, dy, states, final, G, L: int):
    """Stage 3, every (chunk, b, h) at once: ``(dx (x's dtype), ddt
    (b, l, h), dB and dC per head (b, l, h, n), dA per chunk
    (b, c, h))``, all but dx float32.  ``states``: the states entering
    each chunk; ``final``: the state after the last."""
    b, l, h, p = x.shape
    c = l // L
    rep = h // B.shape[2]
    dt_t, cum = _chunked(dt, A, L)                            # (b,c,h,L)
    xc = x.float().reshape(b, c, L, h, p)
    dtc = dt.float().reshape(b, c, L, h)
    xdt = xc * dtc[..., None]
    Bc, Cc = _heads(B, c, L, rep), _heads(C, c, L, rep)
    dyc = dy.float().reshape(b, c, L, h, p)
    E = torch.exp(_segsum(dt_t * _a_rows(A, b)[:, None, :, None]))
    W = torch.einsum("bczhn,bcshn->bchzs", Cc, Bc) * E
    V = torch.einsum("bczhp,bcshp->bchzs", dyc, xdt) * E
    wend = torch.exp(cum[..., -1:] - cum)
    dxdt = (torch.einsum("bchzs,bczhp->bcshp", W, dyc)
            + torch.einsum("bchs,bcshn,bchpn->bcshp", wend, Bc, G))
    dBh = (torch.einsum("bchzs,bczhn->bcshn", V, Cc)
           + torch.einsum("bchs,bcshp,bchpn->bcshn", wend, xdt, G))
    dCh = (torch.einsum("bchzs,bcshn->bczhn", V, Bc)
           + torch.einsum("bchz,bczhp,bchpn->bczhn", torch.exp(cum), dyc,
                          states))
    rx = (xc * dxdt).sum(-1)                                  # (b,c,L,h)
    dcum = ((Cc * dCh).sum(-1) - dtc * rx).permute(0, 1, 3, 2)
    S_next = torch.cat([states[:, 1:], final[:, None]], dim=1)
    dcum[..., -1] += (G * S_next).sum((-2, -1))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = rx.permute(0, 1, 3, 2) + ddA * _a_rows(A, b)[:, None, :, None]
    dA = (ddA * dt_t).sum(-1)                                 # (b,c,h)
    dx = (dxdt * dtc[..., None]).reshape(b, l, h, p).to(x.dtype)
    return (dx, ddt.permute(0, 1, 3, 2).reshape(b, l, h),
            dBh.reshape(b, l, h, -1), dCh.reshape(b, l, h, -1), dA)


def bwd_reduce(dBh: torch.Tensor, dCh: torch.Tensor, dA_chunks: torch.Tensor,
               g: int, dtype: torch.dtype, shared_a: bool
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stage 4: ``(dB, dC, dA)``: dB and dC (b, l, g, n) in ``dtype``, the
    heads of each group summed in order; dA summed over the chunks, and
    over the batch rows too when A was shared (``(h,)``)."""
    b, l, h, n = dBh.shape
    dB = dBh.reshape(b, l, g, h // g, n).sum(3).to(dtype)
    dC = dCh.reshape(b, l, g, h // g, n).sum(3).to(dtype)
    dA = dA_chunks.sum((0, 1)) if shared_a else dA_chunks.sum(1)
    return dB, dC, dA


def ssd_chunked_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    dy: torch.Tensor, dS_last: torch.Tensor):
    """The VJP of ``ssd_chunked`` for the cotangents ``dy (b, l, h, p)``
    and ``dS_last (b, h, p, n)``: ``(dx, ddt, dA, dB, dC)``, dx, dB and dC
    in the dtypes of x, B and C, ddt and dA (A's shape) float32."""
    h = x.shape[2]
    L = min(chunk, x.shape[1])
    _, final, states = chunk_states(x, dt, A, B, C, chunk)
    dG, decay = bwd_dstate(dt, A, C, dy, L, h)
    G = bwd_chain(dG, decay, dS_last)
    dx, ddt, dBh, dCh, dA_chunks = bwd_chunk(x, dt, A, B, C, dy, states,
                                             final, G, L)
    dB, dC, dA = bwd_reduce(dBh, dCh, dA_chunks, B.shape[2], B.dtype,
                            A.dim() == 1)
    return dx, ddt, dA, dB, dC


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
