"""Plain PyTorch version of the flash-attention forward kernel, on the model
layout: q ``(B, Sq, H, Dqk)``, k ``(B, Skv, Hkv, Dqk)``, v ``(B, Skv, Hkv,
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

Materializes the ``(B, H, Sq, Skv)`` float32 scores: fine for tests and
for holding the kernel to it on the card, not for a long context.
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
