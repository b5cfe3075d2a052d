"""Shared low-level layers (``repro.models.layers`` counterpart): norms,
initializers, activations, rotary embeddings.

The initializers draw from a ``torch.Generator`` (which cannot reproduce
``jax.random``'s streams: parity tests carry the reference's weights across
with ``convert.lm_params_from_numpy``).  They take a leading ``lead`` shape
so that one call makes a whole stack of layers, ``(n_groups, count, …)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(generator: torch.Generator, shape: tuple[int, ...], std: float,
            dtype: torch.dtype, lead: tuple[int, ...]) -> torch.Tensor:
    """``N(0, std²)`` drawn in float32, one leading index at a time (so a
    large stack never holds a whole float32 copy), cast to ``dtype``."""
    out = torch.empty(lead + shape, dtype=dtype, device=generator.device)
    if out.is_meta:                  # shapes only (launch.specs)
        return out
    flat = out.view((math.prod(lead),) + shape)
    for i in range(flat.shape[0]):
        flat[i] = (torch.randn(shape, generator=generator,
                               device=generator.device) * std).to(dtype)
    return out


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, lead: tuple[int, ...] = ()
               ) -> torch.Tensor:
    return _normal(generator, (d_in, d_out), (1.0 / d_in) ** 0.5, dtype,
                   lead)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, lead: tuple[int, ...] = ()
               ) -> torch.Tensor:
    return _normal(generator, (vocab, d), 0.02, dtype, lead)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) · (1 + scale)`` in float32, cast back: the scale is
    stored as an offset from 1, so a zero-initialized norm is the identity
    gain."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(dt)


def init_norm(d: int, kind: str, dtype: torch.dtype, device,
              lead: tuple[int, ...] = ()) -> dict:
    if kind == "rms":
        return {"scale": torch.zeros(lead + (d,), dtype=dtype, device=device)}
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    return F.relu(x)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, dim/2)."""
    inv = rope_freqs(dim, theta, positions.device)
    return positions.float()[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) with D even; angles (B, S, D/2) or (S, D/2).

    Rotates the pairs ``(x[..., :D/2], x[..., D/2:])`` — the "rotate_half"
    layout of Llama/Gemma/Qwen — in float32, cast back."""
    dt = x.dtype
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    if angles.dim() == 2:          # (S, D/2) broadcast over batch
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:                          # (B, S, D/2)
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def mrope_angles(positions: torch.Tensor, dim: int, theta: float,
                 sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL).

    positions: (3, B, S) temporal / height / width position ids;
    sections: each axis's number of frequency pairs, summing to dim / 2.
    Returns angles (B, S, dim/2) where frequency slot j takes the position
    id of the axis that owns slot j."""
    assert sum(sections) == dim // 2, (sections, dim)
    inv = rope_freqs(dim, theta, positions.device)
    ang = positions.float()[..., None] * inv          # (3, B, S, dim/2)
    parts, start = [], 0
    for axis, width in enumerate(sections):
        parts.append(ang[axis, :, :, start:start + width])
        start += width
    return torch.cat(parts, dim=-1)
