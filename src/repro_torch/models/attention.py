"""Attention (``repro.models.attention`` counterpart): MHA / GQA / MQA with a
positional per-row KV cache.

In-flight attention (training forward and backward, prefill) goes through
``flash_attention_diff`` (``kernels/flash_attention/ops.py``) whenever
``logit_cap == 0`` and ``is_global`` is a Python bool, on either device: a
CPU tensor takes the plain versions, a CUDA tensor the hand-written
forward kernel and, under autograd, the dq and dk/dv kernels, at any
sequence length.  Soft-capped logits take ``blocked_attention``.
Decode (one query against the cache) stays plain torch, as the reference
computes it outside any kernel.

Cache updates are functional, as in the reference: ``attention`` returns a
new cache dict and never writes the one it was given.  The reference's
``dist.constrain`` sharding hints are dropped (one device; ROADMAP A15).
``cfg.remat`` is not honoured: the port keeps each layer's activations for
the backward (small at the training path's sizes), and
``torch.utils.checkpoint`` does not compose with ``torch.func.vmap``, which
batches the clients of a round (core/flat.py).
MLA (DeepSeek-V2) is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dense_init, softcap

Params = dict[str, Any]
NEG_INF = -2.0 ** 30
BLOCK_Q = 512                 # query rows per block of blocked_attention


def _refuse_mla(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            "MLA attention (DeepSeek-V2) is not ported yet (ROADMAP A12)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    _refuse_mla(cfg)
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p: Params = {
        "wq": dense_init(generator, d, H * hd, dtype, lead),
        "wk": dense_init(generator, d, Hkv * hd, dtype, lead),
        "wv": dense_init(generator, d, Hkv * hd, dtype, lead),
        "wo": dense_init(generator, H * hd, d, dtype, lead),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros(lead + (H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (Hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (Hkv * hd,), dtype=dtype, device=dev)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device, window_only: bool = False,
               lead: tuple[int, ...] = ()) -> Params:
    """Positional KV cache.  ``pos[b, s]`` holds the absolute position
    written to ring slot ``s`` of row ``b`` (-1 = empty), per row, so a
    continuous-batching engine holds requests at different phases in one
    pool; ``idx[b]`` is the row's next ring slot."""
    _refuse_mla(cfg)
    size = (min(max_len, cfg.sliding_window)
            if window_only and cfg.sliding_window else max_len)
    hd = cfg.resolved_head_dim
    kv = lead + (batch, size, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                          device=device),
        "idx": torch.zeros(lead + (batch,), dtype=torch.int32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# masked softmax attention cores
# ---------------------------------------------------------------------------

def _select(is_global, causal, win):
    """The global layer's causal mask or the local layer's window mask;
    ``is_global`` a Python bool or a bool tensor."""
    if isinstance(is_global, bool):
        return causal if is_global else win
    return torch.where(is_global.to(causal.device), causal, win)


def _mask(q_pos, kv_pos, window, is_global):
    """Causal + optional sliding-window mask.  q_pos (Q,), kv_pos (K,)."""
    causal = kv_pos[None, :] <= q_pos[:, None]
    valid = kv_pos[None, :] >= 0
    if window:
        local = kv_pos[None, :] > q_pos[:, None] - window
        sel = _select(is_global, causal, causal & local)
    else:
        sel = causal
    return sel & valid


def _mask_rows(q_pos, kv_pos, window, is_global):
    """Per-row decode mask.  q_pos (B,), kv_pos (B, S) -> (B, S)."""
    causal = kv_pos <= q_pos[:, None]
    valid = kv_pos >= 0
    if window:
        local = kv_pos > q_pos[:, None] - window
        sel = _select(is_global, causal, causal & local)
    else:
        sel = causal
    return sel & valid


def blocked_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                      is_global=True, logit_cap: float = 0.0
                      ) -> torch.Tensor:
    """Causal attention over query blocks (bounded score memory), with
    soft-capped logits.  q (B, Sq, H, D); k, v (B, Skv, Hkv, D).  The
    reference's sliding-window kv band is a saving for local layers, which
    the port does not run yet (ROADMAP A12); here every block scores the
    whole kv length and masks."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = D ** -0.5
    kf, vf = k.float(), v.float()
    out = []
    for s0 in range(0, Sq, BLOCK_Q):
        qi = q[:, s0:s0 + BLOCK_Q]
        bq = qi.shape[1]
        qi = qi.reshape(B, bq, Hkv, g, D).float() * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kf)
        s = softcap(s, logit_cap)
        m = _mask(q_pos[s0:s0 + BLOCK_Q], kv_pos, window, is_global)
        s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        out.append(o.reshape(B, bq, H, v.shape[-1]).to(q.dtype))
    return torch.cat(out, dim=1)


def full_attention(q, k, v, q_pos, *, window: int = 0, is_global=True,
                   logit_cap: float = 0.0) -> torch.Tensor:
    """In-flight (q_pos == kv_pos, contiguous) attention: the flash kernel
    when eligible, ``blocked_attention`` otherwise.  Causal and window masks
    depend only on relative position, so any contiguous offset is exact."""
    if q_pos.dim() == 2:        # (B, S) row positions: masks are relative,
        q_pos = q_pos[0]        # so any row's positions give the same mask
    win = 0 if (is_global is True or not window) else window
    if isinstance(is_global, bool) and logit_cap == 0.0:
        return fa_ops.flash_attention_diff(q, k, v, causal=True, window=win,
                                           scale=q.shape[-1] ** -0.5)
    return blocked_attention(q, k, v, q_pos, q_pos, window=window,
                             is_global=is_global, logit_cap=logit_cap)


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     is_global=True, logit_cap: float = 0.0) -> torch.Tensor:
    """Single-position attention against the cache.  q (B, 1, H, D); k, v
    (B, S, Hkv, D); q_pos (B,); kv_pos (B, S)."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = D ** -0.5
    qr = q.reshape(B, Hkv, g, D).float() * scale
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k.float())
    s = softcap(s, logit_cap)
    m = _mask_rows(q_pos, kv_pos, window, is_global)        # (B, S)
    s = torch.where(m[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def _ring_slots(start: torch.Tensor, S: int, size: int) -> torch.Tensor:
    return (start[:, None].long()
            + torch.arange(S, device=start.device)[None]) % size


def _cache_insert(buf: torch.Tensor, new: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` (B, size, …) with ``new`` (B, S, …) written at the
    per-row ring slots ``(start[b] + arange(S)) % size``.  A write that
    covers the whole ring (S ≥ size) keeps the last ``size`` tokens."""
    B, size = buf.shape[0], buf.shape[1]
    S = new.shape[1]
    rows = torch.arange(B, device=buf.device)[:, None]
    if S >= size:
        # ring slot j of row b ends up holding in-flight index
        # (j − start_b − S) mod size of the last `size` tokens
        tail = new[:, -size:]
        idx = (torch.arange(size, device=buf.device)[None]
               - start[:, None].long() - S) % size
        return tail[rows, idx].to(buf.dtype)
    out = buf.clone()
    out[rows, _ring_slots(start, S, size)] = new.to(buf.dtype)
    return out


def _pos_insert(pos: torch.Tensor, q_pos: torch.Tensor,
                start: torch.Tensor) -> torch.Tensor:
    """pos (B, size); q_pos (B, S) absolute positions; start (B,)."""
    return _cache_insert(pos[..., None], q_pos[..., None].to(torch.int32),
                         start)[..., 0]


# ---------------------------------------------------------------------------
# full attention layer (standard / GQA path)
# ---------------------------------------------------------------------------

def attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              angles: torch.Tensor, q_pos: torch.Tensor, is_global=True,
              cache: Optional[Params] = None
              ) -> tuple[torch.Tensor, Optional[Params]]:
    _refuse_mla(cfg)
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q.reshape(B, S, H, hd), angles)
    k = apply_rope(k.reshape(B, S, Hkv, hd), angles)
    v = v.reshape(B, S, Hkv, hd)

    window = cfg.sliding_window
    if cache is None:
        out = full_attention(q, k, v, q_pos, window=window,
                             is_global=is_global,
                             logit_cap=cfg.attn_logit_softcap)
        new_cache = None
    else:
        slot = cache["idx"]                          # (B,)
        q_pos_rows = (q_pos if q_pos.dim() == 2
                      else q_pos[None].expand(B, S))
        new_cache = {
            "k": _cache_insert(cache["k"], k, slot),
            "v": _cache_insert(cache["v"], v, slot),
            "pos": _pos_insert(cache["pos"], q_pos_rows, slot),
            "idx": cache["idx"] + S,
        }
        if S > 1:
            # prefill into the cache: the cache was empty, so attending
            # over the in-flight sequence is exact
            out = full_attention(q, k, v, q_pos, window=window,
                                 is_global=is_global,
                                 logit_cap=cfg.attn_logit_softcap)
        else:
            out = decode_attention(q, new_cache["k"], new_cache["v"],
                                   q_pos_rows[:, 0], new_cache["pos"],
                                   window=window, is_global=is_global,
                                   logit_cap=cfg.attn_logit_softcap)
    y = out.reshape(B, S, H * hd) @ params["wo"]
    return y, new_cache
