"""Attention (``repro.models.attention`` counterpart): MHA / GQA / MQA,
sliding-window (gemma3's local layers) and MLA (DeepSeek-V2), with a
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
``dist.constrain`` sharding hints stand at the reference's sites; they do
nothing without a mesh.  Under a mesh (``launch/serve.py``) the tensors are
DTensors, and three ops run on each rank's shard in explicit regions: the
flash kernel, which has no DTensor rule, on the local heads and batch rows
(``_flash_sharded``; under ``torch.func.vmap``, when the training round's
local steps run tensor-parallel, on the physical DTensors through
``dist.on_physical``); the cache write, a scatter without one, on the
local rows, heads and ring slots (``_cache_insert_sharded``: a
sequence-sharded cache, the ``long`` kind's, takes only the tokens whose
slots it holds); and decode attention on the local rows and kv heads
(``_decode_sharded``), its softmax combined across a sharded sequence by
all-reduces, as DTensor's einsum rules differ between torch releases.
``cfg.remat`` is not honoured: the port keeps each layer's activations for
the backward (small at the training path's sizes), and
``torch.utils.checkpoint`` does not compose with ``torch.func.vmap``, which
batches the clients of a round (core/flat.py).

A local layer's cache is a ring of ``sliding_window`` slots; a prefill
longer than the ring keeps its last ``size`` tokens by one gather.  MLA
caches the normalised latent ``ckv`` and the shared rope key ``krope``;
its in-flight attention (training, prefill) reaches the flash kernel with
Dqk = dn + dr and Dv = dv, and its decode runs in the latent space
(``mla_decode_absorbed``) or, with ``absorb=False``, up-projects the
whole cache (the reference's A/B baseline).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import constrain
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap

Params = dict[str, Any]
NEG_INF = -2.0 ** 30
BLOCK_Q = 512                 # query rows per block of blocked_attention


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq": dense_init(generator, d, H * qk_dim, dtype, lead),
            "w_kv_down": dense_init(generator, d,
                                    m.kv_lora_rank + m.qk_rope_head_dim,
                                    dtype, lead),
            "w_kv_up": dense_init(generator, m.kv_lora_rank,
                                  H * (m.qk_nope_head_dim + m.v_head_dim),
                                  dtype, lead),
            "wo": dense_init(generator, H * m.v_head_dim, d, dtype, lead),
            "ckv_norm": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                    device=generator.device),
        }
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
    pool; ``idx[b]`` is the row's next ring slot.  An MLA cache holds
    the latent ``ckv (B, size, kv_lora_rank)`` and the rope key ``krope
    (B, size, qk_rope_head_dim)`` in place of ``k`` and ``v``."""
    size = (min(max_len, cfg.sliding_window)
            if window_only and cfg.sliding_window else max_len)
    hd = cfg.resolved_head_dim
    rows = lead + (batch, size)
    if cfg.mla is not None:
        m = cfg.mla
        tensors = {
            "ckv": torch.zeros(rows + (m.kv_lora_rank,), dtype=dtype,
                               device=device),
            "krope": torch.zeros(rows + (m.qk_rope_head_dim,), dtype=dtype,
                                 device=device)}
    else:
        kv = rows + (cfg.n_kv_heads, hd)
        tensors = {"k": torch.zeros(kv, dtype=dtype, device=device),
                   "v": torch.zeros(kv, dtype=dtype, device=device)}
    return {
        **tensors,
        "pos": torch.full(rows, -1, dtype=torch.int32, device=device),
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
    """Causal attention over query blocks of ``BLOCK_Q`` rows (bounded
    score memory), with soft-capped logits.  q (B, Sq, H, D); k, v (B,
    Skv, Hkv, D).  A local layer's in-flight blocks (``is_global`` the
    bool False, Skv the reference's padded Sq) score only the kv band
    ``window + block`` wide that ends with the block, as the reference
    does; the keys outside it are masked anyway, so the result is the
    same."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = D ** -0.5
    bq = min(BLOCK_Q, Sq)
    band = (min(Skv, window + bq)
            if window and is_global is False and Skv == -(-Sq // bq) * bq
            else 0)
    kf, vf = k.float(), v.float()
    out = []
    for s0 in range(0, Sq, bq):
        qi = q[:, s0:s0 + bq]
        nq = qi.shape[1]
        qi = qi.reshape(B, nq, Hkv, g, D).float() * scale
        kk, vv, kp = kf, vf, kv_pos
        if band:
            start = min(max(s0 + bq - band, 0), Skv - band)
            kk, vv = kf[:, start:start + band], vf[:, start:start + band]
            kp = kv_pos[start:start + band]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kk)
        s = softcap(s, logit_cap)
        m = _mask(q_pos[s0:s0 + bq], kp, window, is_global)
        s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vv)
        out.append(o.reshape(B, nq, H, v.shape[-1]).to(q.dtype))
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
        if dist.on_mesh(q):
            return dist.on_physical(
                lambda q, k, v: _flash_sharded(q, k, v, win), q, k, v)
        return fa_ops.flash_attention_diff(q, k, v, causal=True, window=win,
                                           scale=q.shape[-1] ** -0.5)
    return blocked_attention(q, k, v, q_pos, q_pos, window=window,
                             is_global=is_global, logit_cap=logit_cap)


def _flash_sharded(q, k, v, window: int):
    """The flash kernel on each rank's shard of DTensors q (…, S, H, Dqk),
    k (…, S, Hkv, Dqk), v (…, S, Hkv, Dv), the leading dims (the batch, and
    under vmap the clients before it) folded into one: the kernel has no
    DTensor rule, so it runs on the local batch rows and query heads, with
    the kv heads those query heads read (a group of H / Hkv query heads a
    kv head).  k and v take q's batch sharding; a kv head sharding that
    does not line up with q's (GQA on a mesh wider than Hkv: replicated by
    the constrain's drop rule) is sliced locally.  q keeps a sharding of
    its batch or head dim; a partial sum, or a sharding of its sequence or
    head width (which DTensor's propagation can give a projection under
    vmap), is made whole first.  ``to_local`` and the wrap back are
    differentiable, so autograd's backward runs the backward kernels on
    the same shards."""
    from torch.distributed.tensor import Replicate, Shard
    lead = tuple(q.shape[:-3])
    if len(lead) > 1:
        q, k, v = (t.reshape((-1,) + tuple(t.shape[-3:])) for t in (q, k, v))
    mesh = q.device_mesh
    pl = tuple(Replicate() if p.is_partial() or (
        p.is_shard() and p.dim not in (0, 2)) else p for p in q.placements)
    if pl != tuple(q.placements):
        q = q.redistribute(mesh, pl)
    B, S, H, _ = q.shape
    g = H // k.shape[2]
    h0, hl = dist.local_offset(mesh, pl, q.shape, 2)
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    kv_pl = tuple(Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
                  for p in pl)
    if hl % g == 0:
        # whole kv heads a rank: k and v shard their heads as q does, and
        # this rank's shard is kv heads [lo, hi)
        kv_pl = tuple(Shard(2) if p.is_shard() and p.dim == 2 else kp
                      for p, kp in zip(pl, kv_pl))
        k_loc = k.redistribute(mesh, kv_pl).to_local()
        v_loc = v.redistribute(mesh, kv_pl).to_local()
    else:
        # ranks share a kv head: each slices the one its query heads read
        k_loc = k.redistribute(mesh, kv_pl).to_local()[:, :, lo:hi]
        v_loc = v.redistribute(mesh, kv_pl).to_local()[:, :, lo:hi]
    o = fa_ops.flash_attention_diff(q.to_local(), k_loc, v_loc, causal=True,
                                    window=window,
                                    scale=q.shape[-1] ** -0.5)
    o = dist.as_dtensor(o, mesh, pl, (B, S, H, v.shape[-1]))
    return o.reshape(lead + (S, H, v.shape[-1])) if len(lead) > 1 else o


def _decode_scores(q, k, q_pos, kv_pos, window, is_global, logit_cap):
    """Masked float32 scores (B, Hkv, g, S) of one query against the
    cache."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    qr = q.reshape(B, Hkv, H // Hkv, D).float() * D ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k.float())
    s = softcap(s, logit_cap)
    m = _mask_rows(q_pos, kv_pos, window, is_global)        # (B, S)
    return torch.where(m[:, None, None, :], s, NEG_INF)


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     is_global=True, logit_cap: float = 0.0) -> torch.Tensor:
    """Single-position attention against the cache.  q (B, 1, H, D); k, v
    (B, S, Hkv, D); q_pos (B,); kv_pos (B, S)."""
    if dist.is_dtensor(k):
        return _decode_sharded(q, k, v, q_pos, kv_pos, window, is_global,
                               logit_cap)
    B, _, H, _ = q.shape
    s = _decode_scores(q, k, q_pos, kv_pos, window, is_global, logit_cap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def _whole(t) -> torch.Tensor:
    return t.full_tensor() if dist.is_dtensor(t) else t


def _decode_sharded(q, k, v, q_pos, kv_pos, window, is_global, logit_cap):
    """``decode_attention`` on each rank's shard of the DTensor cache k, v
    (B, S, Hkv, D): its batch rows, kv heads and ring slots.  q takes k's
    batch and head sharding (the query heads of the local kv heads), the
    positions their local rows and slots.  Where the cache's sequence is
    whole on a rank this is the plain function on the local rows and
    heads; where it is sharded (the ``long`` kind) each rank scores its
    own slots and the softmax is combined across the sequence's mesh dims
    by three all-reduces (the rows' max, the exponentials' sum, the
    weighted values' sum).  The result takes q's placements, the sequence's
    mesh dims replicated."""
    import torch.distributed as tdist
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = k.device_mesh, tuple(k.placements)
    if any(p.is_partial() or (p.is_shard() and p.dim == 3) for p in pl):
        raise NotImplementedError(
            f"decode attention under a mesh shards batch, sequence and kv "
            f"heads only; the cache has placements {pl}")
    v = v.redistribute(mesh, pl)
    q_pl = tuple(Shard(p.dim) if p.is_shard() and p.dim in (0, 2)
                 else Replicate() for p in pl)
    q = dist.as_dtensor(q, mesh, (Replicate(),) * mesh.ndim).redistribute(
        mesh, q_pl)
    b0, bn = dist.local_offset(mesh, pl, k.shape, 0)
    s0, sn = dist.local_offset(mesh, pl, k.shape, 1)
    q_pos = _whole(q_pos)[b0:b0 + bn]
    kv_pos = _whole(kv_pos)[b0:b0 + bn, s0:s0 + sn]
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    B, _, H, _ = ql.shape
    seq = [i for i, p in enumerate(pl) if p.is_shard() and p.dim == 1]
    if not seq:
        o = decode_attention(ql, kl, vl, q_pos, kv_pos, window=window,
                             is_global=is_global, logit_cap=logit_cap)
    else:
        s = _decode_scores(ql, kl, q_pos, kv_pos, window, is_global,
                           logit_cap)
        m = s.amax(dim=-1, keepdim=True)
        for i in seq:
            tdist.all_reduce(m, tdist.ReduceOp.MAX, group=mesh.get_group(i))
        e = torch.exp(s - m)
        total = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgk,bkhd->bhgd", e, vl.float())
        for i in seq:
            tdist.all_reduce(total, group=mesh.get_group(i))
            tdist.all_reduce(o, group=mesh.get_group(i))
        o = (o / total).reshape(B, 1, H, vl.shape[-1]).to(ql.dtype)
    return dist.as_dtensor(o, mesh, q_pl, tuple(q.shape[:3]) + (
        v.shape[-1],))


def _ring_slots(start: torch.Tensor, S: int, size: int) -> torch.Tensor:
    return (start[:, None].long()
            + torch.arange(S, device=start.device)[None]) % size


def _cache_insert(buf: torch.Tensor, new: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` (B, size, …) with ``new`` (B, S, …) written at the
    per-row ring slots ``(start[b] + arange(S)) % size``.  A write that
    covers the whole ring (S ≥ size) keeps the last ``size`` tokens."""
    if dist.is_dtensor(buf):
        return _cache_insert_sharded(buf, new, start)
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


def _cache_insert_sharded(buf, new, start):
    """``_cache_insert`` on each rank's shard of the DTensor ``buf``: the
    scatter has no DTensor rule.  ``new`` takes ``buf``'s placements with
    its sequence (the in-flight tokens) whole, ``start`` ``buf``'s batch
    sharding; a rank whose shard of ``buf`` holds ring slots [lo, lo + n)
    writes the tokens that land there, at slot − lo."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = buf.device_mesh, tuple(buf.placements)
    new_pl = tuple(Replicate() if p.is_shard() and p.dim == 1 else p
                   for p in pl)
    start_pl = tuple(Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
                     for p in pl)
    new = dist.as_dtensor(new, mesh, (Replicate(),) * mesh.ndim
                          ).redistribute(mesh, new_pl).to_local()
    start = dist.as_dtensor(start, mesh, (Replicate(),) * mesh.ndim
                            ).redistribute(mesh, start_pl).to_local()
    lo, n = dist.local_offset(mesh, pl, buf.shape, 1)
    size, S = buf.shape[1], new.shape[1]
    local = buf.to_local()
    rows = torch.arange(local.shape[0], device=local.device)[:, None]
    if S >= size:
        slots = lo + torch.arange(n, device=local.device)[None]
        idx = (slots - start[:, None].long() - S) % size
        out = new[:, -size:][rows, idx].to(local.dtype)
    else:
        slots = _ring_slots(start, S, size)                  # (B, S)
        keep = (slots >= lo) & (slots < lo + n)
        # the tokens that land on other ranks write a spare slot n, cut
        # off after: no shape depends on the data
        out = torch.cat([local, local[:, :1]], dim=1)
        out[rows, torch.where(keep, slots - lo, n)] = new.to(local.dtype)
        out = out[:, :n].contiguous()
    return dist.as_dtensor(out, mesh, pl, buf.shape)


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
              cache: Optional[Params] = None, seq_shard: bool = False
              ) -> tuple[torch.Tensor, Optional[Params]]:
    if cfg.mla is not None:
        return mla_attention(params, x, cfg, angles=angles, q_pos=q_pos,
                             cache=cache, seq_shard=seq_shard)
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    # on a mesh, a projection sharded in pieces that split a head (a model
    # axis wider than the heads) is made whole before the split
    q = apply_rope(dist.split_heads(q, H), angles)
    k = apply_rope(dist.split_heads(k, Hkv), angles)
    v = dist.split_heads(v, Hkv)
    # constrain drops any axis that does not divide: kv heads stay
    # replicated on meshes wider than Hkv
    q = constrain(q, "dp", None, "mp", None)
    k = constrain(k, "dp", None, "mp", None)

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
            kc, vc = new_cache["k"], new_cache["v"]
            if seq_shard:
                kc = constrain(kc, "dp", "sp", None, None)
                vc = constrain(vc, "dp", "sp", None, None)
            out = decode_attention(q, kc, vc, q_pos_rows[:, 0],
                                   new_cache["pos"], window=window,
                                   is_global=is_global,
                                   logit_cap=cfg.attn_logit_softcap)
    out = constrain(out, "dp", None, "mp", None)
    y = out.reshape(B, S, H * hd) @ params["wo"]
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_decode_absorbed(params: Params, cfg: ModelConfig,
                        q_nope: torch.Tensor, q_rope: torch.Tensor,
                        cache: Params, q_pos: torch.Tensor, *,
                        seq_shard: bool = False) -> torch.Tensor:
    """Weight-absorbed MLA decode: scores and outputs in the
    ``kv_lora_rank``-dimensional latent space,

        q̃ = q_nope · W_uk,  s = q̃ · ckvᵀ + q_rope · kropeᵀ,
        õ = softmax(s) · ckv,  o = õ · W_uv,

    equal in exact arithmetic to up-projecting the whole cache.
    q_nope (B, H, dn), q_rope (B, H, dr), q_pos (B,) -> o (B, 1, H, dv).

    The reference keeps the cache in its storage dtype and accumulates
    each product in float32 (``preferred_element_type``), rounding q̃, p
    and õ to the storage dtype before the product that reads them.  torch
    has no such option, so each product here takes its operands, already
    rounded to the storage dtype, in float32: the products of two bfloat16
    values are exact in float32, so this is the reference's arithmetic up
    to the order of the sums (not a bfloat16 matmul, which would round the
    scores to bfloat16 before the softmax).  The price is a float32 copy
    of ``ckv`` and ``krope`` a layer a tick: twice the cache's bytes read
    again, small beside a tick's weight reads at the served lengths."""
    m = cfg.mla
    H = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    B = q_nope.shape[0]
    w_up = params["w_kv_up"].reshape(m.kv_lora_rank, H, dn + dv).float()
    w_uk, w_uv = w_up[..., :dn], w_up[..., dn:]
    ckv, krope = cache["ckv"], cache["krope"]
    if seq_shard:
        ckv = constrain(ckv, "dp", "sp", None)
        krope = constrain(krope, "dp", "sp", None)
    cd = ckv.dtype
    ckv, krope = ckv.float(), krope.float()                  # (B, S, r/dr)
    scale = (dn + dr) ** -0.5
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk)
    s = (torch.einsum("bhr,bsr->bhs", q_abs.to(cd).float(), ckv)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), krope)) * scale
    s = softcap(s, cfg.attn_logit_softcap)
    mask = _mask_rows(q_pos, cache["pos"], 0, True)          # (B, S)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p.to(cd).float(), ckv)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(cd).float(), w_uv)
    return o.reshape(B, 1, H, dv).to(cd)


def mla_attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  angles: torch.Tensor, q_pos: torch.Tensor,
                  cache: Optional[Params] = None, seq_shard: bool = False
                  ) -> tuple[torch.Tensor, Optional[Params]]:
    """Multi-head latent attention.  The rope part of q and of the shared
    key takes the first ``dr / 2`` frequencies of the table built for the
    model's head dim (the reference's partial rope); the latent ``ckv`` is
    normalised by ``rms_norm`` (a ``1 + scale`` gain) before it is cached
    or up-projected."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q = (x @ params["wq"]).reshape(B, S, H, dn + dr)
    ang_r = angles[..., :dr // 2]
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], ang_r)
    kv = x @ params["w_kv_down"]
    ckv = rms_norm(kv[..., :m.kv_lora_rank], params["ckv_norm"],
                   cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], ang_r)  # (B,S,1,dr)

    def expand(ckv_seq: torch.Tensor):
        up = (ckv_seq @ params["w_kv_up"]).reshape(B, -1, H, dn + dv)
        return up[..., :dn], up[..., dn:]

    def in_flight(constrained: bool = False) -> torch.Tensor:
        k_nope, v = expand(ckv)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        if constrained:                 # the reference's training path
            qq = constrain(qq, "dp", None, "mp", None)
        return full_attention(qq, k, v, q_pos,
                              logit_cap=cfg.attn_logit_softcap)

    if cache is None:
        out, new_cache = in_flight(constrained=True), None
    else:
        slot = cache["idx"]                          # (B,)
        q_pos_rows = (q_pos if q_pos.dim() == 2
                      else q_pos[None].expand(B, S))
        new_cache = {
            "ckv": _cache_insert(cache["ckv"], ckv, slot),
            "krope": _cache_insert(cache["krope"], k_rope[:, :, 0], slot),
            "pos": _pos_insert(cache["pos"], q_pos_rows, slot),
            "idx": cache["idx"] + S,
        }
        if S > 1:
            # prefill into the cache: the cache was empty, so attending
            # over the in-flight sequence is exact
            out = in_flight()
        elif not m.absorb:
            # the naive decode: the whole cache up-projected every token
            ckv_c = new_cache["ckv"]
            if seq_shard:
                ckv_c = constrain(ckv_c, "dp", "sp", None)
            k_nope, v = expand(ckv_c)
            size = k_nope.shape[1]
            k = torch.cat([k_nope, new_cache["krope"][:, :, None].expand(
                B, size, H, dr)], dim=-1)
            out = decode_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                   q_pos_rows[:, 0], new_cache["pos"],
                                   logit_cap=cfg.attn_logit_softcap)
        else:
            out = mla_decode_absorbed(params, cfg, q_nope[:, 0],
                                      q_rope[:, 0], new_cache,
                                      q_pos_rows[:, 0], seq_shard=seq_shard)
    out = constrain(out, "dp", None, "mp", None)
    y = out.reshape(B, S, H * dv) @ params["wo"]
    return y, new_cache
