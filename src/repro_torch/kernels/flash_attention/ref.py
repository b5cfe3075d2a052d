"""Plain PyTorch versions of the flash-attention kernels, forward and
backward, on the model layout: q ``(B, Sq, H, Dqk)``, k ``(B, Skv, Hkv, Dqk)``, v ``(B, Skv, Hkv,
Dv)``, GQA query head ``h`` reading kv head ``h // (H / Hkv)``.

What ``_attn_kernel`` of ``src/repro/kernels/flash_attention/kernel.py``
computes, without its blocks: scores ``s = (q·scale)·kᵀ`` in float32 (q is
scaled first, as there); key ``kp`` is visible from query ``qp`` when
``kp ≤ qp`` (causal) and ``kp > qp − window`` (window > 0), both positions
counted from 0; hidden scores take the reference's ``NEG_INF = −2³⁰`` in the
row max and weigh exactly 0 in the sums; ``m`` is the row max, ``l`` the
sum of ``exp(s − m)``, ``o = (p·v) / max(l, 1e-30)`` cast to q's dtype and
``lse = m + log(max(l, 1e-30))`` in float32, shaped ``(B, H, Sq)``.  A row
that sees no key (possible only when Skv < Sq under a window) gives
``o = 0``.  The CUDA kernel (``csrc/flash_attention.cu``) does the same
arithmetic with another summation order.

``attention_bwd`` is what the backward kernels ``_dq_kernel`` and
``_dkv_kernel`` of ``src/repro/kernels/flash_attention/backward.py``
compute together: with ``p = exp(s − lse)`` recomputed from the forward's
``lse`` (hidden keys weigh exactly 0), ``δ = rowsum(do ∘ o)``, ``dp = do·vᵀ``
and ``ds = p ∘ (dp − δ)``, it returns ``dq = scale·ds·k``, ``dk = scale·dsᵀ·q``
and ``dv = pᵀ·do``, dk and dv summed over the g query heads of each kv head,
all in float32 and cast to the inputs' dtypes.  The CUDA kernels
(``csrc/flash_attention_bwd.cu``) do the same arithmetic in another order.

Both materialize the ``(B, H, Sq, Skv)`` float32 scores: fine for tests and
for holding the kernels to them on the card, not for a long context.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def visible(Sq: int, Skv: int, causal: bool, window: int,
            device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query attends."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    kv_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = kv_pos <= q_pos
    if window:
        mask = mask & (kv_pos > q_pos - window)
    return mask


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o (B, Sq, H, Dv) in q's dtype, lse (B, H, Sq) float32)``."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    qr = q.float().reshape(B, Sq, Hkv, g, D) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float())
    mask = visible(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return o, lse



def row_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``δ = rowsum(do ∘ o)`` in float32, shaped ``(B, H, Sq)``: the one
    plain reduction both backward kernels read."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd(q, k, v, do, lse, delta, causal, window, scale, want_dq,
         want_dkv):
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, g, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Hkv, g, Dv)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
    mask = visible(Sq, Skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1)), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.reshape(B, Hkv, g, Sq, 1))
    out = ()
    if want_dq:
        dq = scale * torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
        out += (dq.reshape(B, Sq, H, D).to(q.dtype),)
    if want_dkv:
        dk = scale * torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
        dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
        out += (dk.to(k.dtype), dv.to(v.dtype))
    return out


def attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                     window: int = 0, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """What the dq kernel computes: ``dq`` in q's dtype, from the forward's
    float32 ``lse`` and ``delta = row_delta(do, o)``, both ``(B, H, Sq)``."""
    return _bwd(q, k, v, do, lse, delta, causal, window, scale, True,
                False)[0]


def attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                      window: int = 0, scale: Optional[float] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """What the dk/dv kernel computes: ``(dk, dv)`` in k's and v's dtypes,
    summed over each kv head's query heads."""
    return _bwd(q, k, v, do, lse, delta, causal, window, scale, False,
                True)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``attention_fwd``'s ``o`` for the cotangent ``do``
    (``(B, Sq, H, Dv)``), from the forward's ``o`` and ``lse``.  Returns
    ``(dq, dk, dv)`` shaped and typed as ``(q, k, v)``: both kernels' work
    in one pass."""
    return _bwd(q, k, v, do, lse, row_delta(do, o), causal, window, scale,
                True, True)
