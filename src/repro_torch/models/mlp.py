"""Dense feed-forward (``repro.models.mlp`` counterpart): GLU (SwiGLU /
GeGLU) or a plain two-layer MLP, with optional biases."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import constrain
from repro_torch.models.layers import activation, dense_init


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, d_ff: Optional[int] = None,
             lead: tuple[int, ...] = ()) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    p = {"w_in": dense_init(generator, d, f, dtype, lead),
         "w_out": dense_init(generator, f, d, dtype, lead)}
    if cfg.glu:
        p["w_gate"] = dense_init(generator, d, f, dtype, lead)
    if cfg.mlp_bias:
        dev = generator.device
        p["b_in"] = torch.zeros(lead + (f,), dtype=dtype, device=dev)
        p["b_out"] = torch.zeros(lead + (d,), dtype=dtype, device=dev)
    return p


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ params["w_in"]
    if cfg.mlp_bias:
        h = h + params["b_in"]
    if cfg.glu:
        h = activation(x @ params["w_gate"], cfg.act) * h
    else:
        h = activation(h, cfg.act)
    h = constrain(h, "dp", None, "mp")
    y = h @ params["w_out"]
    if cfg.mlp_bias:
        y = y + params["b_out"]
    return y
