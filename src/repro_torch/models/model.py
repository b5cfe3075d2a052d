"""LM assembly and losses (``repro.models.model`` counterpart): embeddings →
block segments → head.

Parameters and caches keep the reference's tree, ``{"segments": [...],
"embed", "head" (or the audio front end's "heads"), "final_norm"}`` and
one cache dict per segment, with every layer leaf stacked ``(n_groups,
count, …)``, so weights carried across from JAX
(``convert.lm_params_from_numpy``) drop in as they are.
The reference's ``lax.scan`` over the stack is a Python loop over
``(group, layer)`` views of the same tensors.

The port runs every architecture of the registry: the text, audio and
vision front ends; uniform attention stacks (dense MHA / GQA / MQA, GLU or
plain MLP, QKV bias, tied embeddings; MoE feed-forward and MLA
attention); gemma3's local / global stacks (groups of ``global_every − 1``
sliding-window layers, whose caches are rings of ``sliding_window``
slots, then one global layer); Mamba2 stacks; xLSTM stacks (groups of
``slstm_every − 1`` mLSTM layers, then one sLSTM layer); and the zamba2
hybrid: groups of Mamba2 layers, each group followed by one attention
block whose weights every group shares (``params["shared_attn"]``, its
segment ``{}`` in ``params["segments"]``) and whose cache is the group's
own (``caches[si][g, 0]``).

The audio front end (musicgen) sums K codebooks' embeddings
(``params["embed"]`` (K, V, d)) and predicts every codebook
(``params["heads"]`` (K, d, V), logits (B, S, K, V)); its batches carry
``codes`` (B, K, S).  The vision front end (qwen2-vl) takes precomputed
``embeds`` (B, S, d) and ``positions`` (B, 3, S), the temporal / height /
width ids that M-RoPE rotates by; the cache's positions are still
``pos_offset`` + 0 … S − 1.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree_util import tree_map
from repro_torch.dist import constrain
from repro_torch.device import resolve_device
from repro_torch.models.blocks import (apply_block, init_block,
                                       init_block_cache)
from repro_torch.models.layers import (apply_norm, embed_init, init_norm,
                                       mrope_angles, rope_angles)

Params = dict[str, Any]


def group_spec(cfg: ModelConfig) -> tuple[list[tuple[str, int, bool]], int]:
    """The reference's segment layout: [(kind, count, shared)] per group,
    and the number of groups."""
    if cfg.hybrid_attn_every:
        e = cfg.hybrid_attn_every
        assert cfg.n_layers % e == 0, (cfg.n_layers, e)
        return ([("mamba2", e, False), ("attn", 1, cfg.hybrid_shared_attn)],
                cfg.n_layers // e)
    if cfg.xlstm is not None:
        e = cfg.xlstm.slstm_every
        assert cfg.n_layers % e == 0
        return [("mlstm", e - 1, False), ("slstm", 1, False)], cfg.n_layers // e
    if cfg.sliding_window and cfg.global_every:
        e = cfg.global_every
        assert cfg.n_layers % e == 0
        return ([("attn_local", e - 1, False), ("attn_global", 1, False)],
                cfg.n_layers // e)
    kind = "mamba2" if (cfg.family == "ssm" and cfg.xlstm is None) else "attn"
    return [(kind, 1, False)], cfg.n_layers


def _dtype(cfg: ModelConfig, dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype or cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype: Union[str, torch.dtype, None] = None,
                device=None) -> Params:
    """Random weights drawn on ``generator``'s device (a CUDA generator
    makes a full-size model on the card in seconds), then moved to
    ``device`` if another one is given."""
    dt = _dtype(cfg, dtype)
    segments, n_groups = group_spec(cfg)
    params: Params = {"segments": []}
    for kind, count, shared in segments:
        if shared:
            params["segments"].append({})
            params["shared_attn"] = init_block(generator, kind, cfg, dt)
            continue
        params["segments"].append(
            init_block(generator, kind, cfg, dt, lead=(n_groups, count)))
    if cfg.frontend == "audio":
        K = (cfg.n_codebooks,)
        params["embed"] = embed_init(generator, cfg.vocab, cfg.d_model, dt,
                                     K)
        params["heads"] = embed_init(generator, cfg.d_model, cfg.vocab, dt,
                                     K)
    else:
        params["embed"] = embed_init(generator, cfg.vocab, cfg.d_model, dt)
        if not cfg.tie_embeddings:
            params["head"] = embed_init(generator, cfg.d_model, cfg.vocab,
                                        dt)
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm, dt,
                                     generator.device)
    if device is not None:
        params = tree_map(lambda t: t.to(device), params)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: Union[str, torch.dtype, None] = None,
                device=None) -> list:
    """Empty caches on ``device`` (``None``: the card; it raises where
    there is none)."""
    dt = _dtype(cfg, dtype)
    device = resolve_device(device)
    segments, n_groups = group_spec(cfg)
    return [init_block_cache(kind, cfg, batch, max_len, dt, device,
                             lead=(n_groups, count))
            for kind, count, _shared in segments]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _row_positions(B: int, S: int, pos_offset, device) -> torch.Tensor:
    """(B, S) int32 absolute positions from a scalar or per-row (B,)
    offset — per-row offsets let a continuous-batching engine hold requests
    at different phases in one cache pool (serving/engine.py)."""
    off = torch.as_tensor(pos_offset, dtype=torch.int32, device=device)
    if off.dim() == 0:
        off = off[None].expand(B)
    return off[:, None] + torch.arange(S, dtype=torch.int32,
                                       device=device)[None]


def _embed(params: Params, batch: dict, cfg: ModelConfig, pos_offset):
    if cfg.frontend == "vision":
        h = batch["embeds"].to(_dtype(cfg, None))
        B, S = h.shape[0], h.shape[1]
        angles = mrope_angles(batch["positions"].transpose(0, 1),
                              cfg.resolved_head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
        return h, _row_positions(B, S, pos_offset, h.device), angles
    if cfg.frontend == "audio":
        codes = batch["codes"].long()                        # (B, K, S)
        B, S = codes.shape[0], codes.shape[-1]
        # the reference's order: sum() from 0, then e_0, e_1, … in the
        # model dtype (another order rounds differently in bfloat16)
        h = sum(params["embed"][k][codes[:, k]]
                for k in range(cfg.n_codebooks))
        q_pos = _row_positions(B, S, pos_offset, h.device)
        return h, q_pos, rope_angles(q_pos, cfg.resolved_head_dim,
                                     cfg.rope_theta)
    tokens = batch["tokens"]
    B, S = tokens.shape[0], tokens.shape[-1]
    # a gather, as indexing is; on a vocab-sharded DTensor each rank looks
    # up its own rows (indexing would gather the whole table first)
    h = F.embedding(tokens.long(), params["embed"])
    q_pos = _row_positions(B, S, pos_offset, h.device)
    angles = rope_angles(q_pos, cfg.resolved_head_dim, cfg.rope_theta)
    return h, q_pos, angles


def forward(params: Params, batch: dict, cfg: ModelConfig, *,
            caches: Optional[list] = None, pos_offset=0,
            seq_shard: bool = False, last_only: bool = False,
            donate: bool = False
            ) -> tuple[torch.Tensor, Optional[list], torch.Tensor]:
    """Returns (logits, new_caches, aux_loss).  ``last_only`` computes the
    LM head only for the final position (serving prefill); ``seq_shard``
    reads attention caches sequence-sharded (long decode on a mesh);
    ``donate`` writes the new caches into ``caches``' own buffers (each
    layer's after that layer has read its own), so a serving step holds
    one cache where a functional update holds two."""
    segments, n_groups = group_spec(cfg)
    h, q_pos, angles = _embed(params, batch, cfg, pos_offset)
    h = constrain(h, "dp", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # each layer's new cache goes into one stacked buffer a leaf as soon as
    # the layer returns it (the given cache's own, donated), so no third
    # cache of per-layer pieces is ever held
    new_caches = None if caches is None else [{} for _ in segments]
    for g in range(n_groups):
        for si, (kind, count, shared) in enumerate(segments):
            for c in range(count):
                p = (params["shared_attn"] if shared else
                     tree_map(lambda t: t[g, c], params["segments"][si]))
                cache = (None if caches is None
                         else tree_map(lambda t: t[g, c], caches[si]))
                h, nc, a = apply_block(p, kind, h, cfg, angles=angles,
                                       q_pos=q_pos, cache=cache,
                                       seq_shard=seq_shard)
                aux = aux + a
                if new_caches is not None:
                    out = new_caches[si]
                    for key, t in nc.items():
                        if key not in out:
                            old = caches[si][key]
                            out[key] = (old if donate and old.dtype == t.dtype
                                        else torch.empty_like(old,
                                                              dtype=t.dtype))
                        out[key][g, c] = t

    h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    if cfg.frontend == "audio":
        logits = torch.einsum("bsd,kdv->bskv", h, params["heads"])
    elif cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["head"]
    # the audio head's logits (B, S, K, V) keep the codebook axis whole
    logits = constrain(logits, "dp", *(None,) * (logits.dim() - 2), "mp")
    return logits, new_caches, aux


# ---------------------------------------------------------------------------
# losses / steps
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.

    The same exact masked reduction as the reference: logsumexp minus the
    masked sum of the label's logit (adding exact zeros), then the mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    mask = labels[..., None] == torch.arange(v, device=labels.device,
                                             dtype=labels.dtype)
    ll = torch.where(mask, logits, 0.0).sum(dim=-1)
    return (lse - ll).mean()


def lm_loss(params: Params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    logits, _, aux = forward(params, batch, cfg)
    labels = batch["labels"]
    if cfg.frontend == "audio":
        labels = labels.transpose(1, 2)                      # (B, S, K)
    return cross_entropy(logits, labels) + aux


def serve_prefill(params: Params, batch: dict, cfg: ModelConfig,
                  caches: Optional[list] = None, donate: bool = False):
    """Fill the KV caches for the prompt, return last-position logits."""
    logits, new_caches, _ = forward(params, batch, cfg, caches=caches,
                                    last_only=True, donate=donate)
    return logits, new_caches


def serve_decode(params: Params, batch: dict, caches: list, pos_offset,
                 cfg: ModelConfig, seq_shard: bool = False,
                 donate: bool = False):
    logits, new_caches, _ = forward(params, batch, cfg, caches=caches,
                                    pos_offset=pos_offset,
                                    seq_shard=seq_shard, donate=donate)
    return logits, new_caches
