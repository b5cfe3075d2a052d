"""Residual blocks (``repro.models.blocks`` counterpart) with the uniform
``(params, cache)`` calling convention of the reference: the attention
kinds (global, local and MLA attention) with a dense MLP or an MoE
feed-forward, whose load-balance loss is the block's aux loss, and the
pre-normed Mamba2, mLSTM and sLSTM mixers."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import apply_norm, init_norm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe

Params = dict[str, Any]

ATTN_KINDS = ("attn", "attn_local", "attn_global")
# the pre-normed mixers: kind -> (params key, module's init, init_cache,
# apply)
MIXERS = {
    "mamba2": ("mamba", mamba_mod.init_mamba, mamba_mod.init_mamba_cache,
               mamba_mod.mamba),
    "mlstm": ("mlstm", xlstm_mod.init_mlstm, xlstm_mod.init_mlstm_cache,
              xlstm_mod.mlstm),
    "slstm": ("slstm", xlstm_mod.init_slstm, xlstm_mod.init_slstm_cache,
              xlstm_mod.slstm),
}


def _check_kind(kind: str) -> None:
    if kind not in ATTN_KINDS and kind not in MIXERS:
        raise ValueError(kind)


def init_block(generator: torch.Generator, kind: str, cfg: ModelConfig,
               dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    _check_kind(kind)
    dev = generator.device
    if kind in MIXERS:
        key, init, _, _ = MIXERS[kind]
        return {"norm": init_norm(cfg.d_model, cfg.norm, dtype, dev, lead),
                key: init(generator, cfg, dtype, lead)}
    p = {
        "norm1": init_norm(cfg.d_model, cfg.norm, dtype, dev, lead),
        "attn": attn_mod.init_attention(generator, cfg, dtype, lead),
        "norm2": init_norm(cfg.d_model, cfg.norm, dtype, dev, lead),
    }
    if cfg.moe is not None:
        p["moe"] = init_moe(generator, cfg, dtype, lead)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(generator, cfg, dtype, lead=lead)
    return p


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype, device,
                     lead: tuple[int, ...] = ()) -> Params:
    _check_kind(kind)
    if kind in MIXERS:
        return MIXERS[kind][2](cfg, batch, dtype, device, lead)
    return attn_mod.init_cache(cfg, batch, max_len, dtype, device,
                               window_only=(kind == "attn_local"), lead=lead)


def apply_block(params: Params, kind: str, x: torch.Tensor,
                cfg: ModelConfig, *, angles, q_pos,
                cache: Optional[Params], seq_shard: bool = False
                ) -> tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  ``seq_shard``: an attention
    decode reads its cache sequence-sharded (the ``long`` kind)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in MIXERS:
        key, _, _, apply = MIXERS[kind]
        h = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps)
        y, new_cache = apply(params[key], h, cfg, cache)
        return x + y, new_cache, aux
    h = apply_norm(params["norm1"], x, cfg.norm, cfg.norm_eps)
    is_global = kind != "attn_local" if cfg.sliding_window else True
    a, new_cache = attn_mod.attention(
        params["attn"], h, cfg, angles=angles, q_pos=q_pos,
        is_global=is_global, cache=cache, seq_shard=seq_shard)
    x = x + a
    if cfg.moe is not None:
        h = apply_norm(params["norm2"], x, cfg.norm, cfg.norm_eps)
        y, aux = moe(params["moe"], h, cfg)
        x = x + y
    elif cfg.d_ff:
        h = apply_norm(params["norm2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp(params["mlp"], h, cfg)
    return x, new_cache, aux
