"""xLSTM blocks (``repro.models.xlstm`` counterpart; Beck et al.,
arXiv:2405.04517).

mLSTM: matrix-memory LSTM with exponential gating.  A prompt (no cache, or
a prefill) takes the stabilised *parallel* form, equal to the recurrence
because the stabiliser m_t = F_t + cummax(log i_s − F_s) is the recurrent
running max; one token takes the O(1)-state recurrence (``_mlstm_step``).
The parallel form masks the decay's exponent to −inf above the diagonal
before ``exp``: the reference multiplies ``exp`` by the mask after it, and
``exp`` overflows there once the gates' cumulative sums drift far enough
(≈ 1800 tokens at the first head's forget bias of 3), giving inf · 0 = NaN
rows (ROADMAP C21).  Wherever the reference is finite the two agree.

A cache with S > 1 is a prefill: like the reference, it reads neither the
cache's ``conv`` nor its ``C`` / ``n`` / ``m`` and writes the state of the
prompt alone, so a chunked prefill restarts every mLSTM layer (ROADMAP
C22).  A prefill shorter than ``conv_dim − 1`` tokens would leave a
convolution cache too short for the next decode step, where the reference
fails on a shape; the port refuses it at the prefill.

sLSTM: scalar-memory LSTM with block-diagonal recurrent weights, a Python
loop over time (the reference's ``lax.scan``).  Gate weights, biases and
every recurrent state are float32 whatever the model dtype, as in the
reference.  Everything here is plain torch: the reference computes xLSTM
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, activation, dense_init, rms_norm
from repro_torch.models.mamba2 import _causal_conv

Params = dict[str, Any]


def _mdims(cfg: ModelConfig):
    x = cfg.xlstm
    assert x is not None
    d_in = int(x.proj_factor * cfg.d_model)
    H = cfg.n_heads
    return x, d_in, H, d_in // H


def _const(values: torch.Tensor, lead: tuple[int, ...]) -> torch.Tensor:
    return values.expand(lead + values.shape).clone()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    x, d_in, H, hd = _mdims(cfg)
    d = cfg.d_model
    dev = generator.device
    f32 = torch.float32
    return {
        "up": dense_init(generator, d, 2 * d_in, dtype, lead),
        "conv_w": _normal(generator, (x.conv_dim, d_in),
                          (1.0 / x.conv_dim) ** 0.5, dtype, lead),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "wq": dense_init(generator, d_in, d_in, dtype, lead),
        "wk": dense_init(generator, d_in, d_in, dtype, lead),
        "wv": dense_init(generator, d_in, d_in, dtype, lead),
        "w_gates": dense_init(generator, d_in, 2 * H, f32, lead),
        "b_gates": _const(torch.cat([
            torch.zeros(H, dtype=f32, device=dev),
            3.0 + torch.arange(H, dtype=f32, device=dev)]), lead),
        "out_norm": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "down": dense_init(generator, d_in, d, dtype, lead),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device, lead: tuple[int, ...] = ()) -> Params:
    """The last ``conv_dim − 1`` convolution inputs (model dtype) and the
    float32 state: ``C`` (B, H, hd, hd), ``n`` (B, H, hd), ``m`` (B, H)
    at −inf."""
    x, d_in, H, hd = _mdims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.zeros(lead + (batch, x.conv_dim - 1, d_in),
                            dtype=dtype, device=device),
        "C": torch.zeros(lead + (batch, H, hd, hd), dtype=f32,
                         device=device),
        "n": torch.zeros(lead + (batch, H, hd), dtype=f32, device=device),
        "m": torch.full(lead + (batch, H), -torch.inf, dtype=f32,
                        device=device),
    }


def _mlstm_parallel(q, k, v, log_i, log_f, block_q: int = 256
                    ) -> torch.Tensor:
    """q, k, v (B, S, H, hd); log_i, log_f (B, S, H) -> h (B, S, H, hd)
    float32.  The stabilised parallel form, ``block_q`` query rows at a
    time against the keys up to the block's last row (the later ones
    are masked to exact zeros)."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    Fc = torch.cumsum(log_f, dim=1)                   # (B,S,H)
    a = log_i - Fc                                    # log ĩ_s − F_s
    amax = torch.cummax(a, dim=1).values              # running max
    m = Fc + amax                                     # recurrent-equal
    kf = k.float() * scale
    vf = v.float()
    a_t, amax_t = a.transpose(1, 2), amax.transpose(1, 2)   # (B,H,S)
    pos = torch.arange(S, device=q.device)
    nums, dens = [], []
    for lo in range(0, S, block_q):
        hi = min(lo + block_q, S)
        sc = torch.einsum("bqhd,bshd->bhqs", q[:, lo:hi].float(), kf[:, :hi])
        # the exponent masked before exp: nothing overflows above the
        # diagonal (C21)
        visible = pos[None, :hi] <= pos[lo:hi, None]            # (q, s)
        expo = torch.where(visible, a_t[:, :, None, :hi]
                           - amax_t[:, :, lo:hi, None], -torch.inf)
        st = sc * torch.exp(expo)                                # (B,H,q,s)
        nums.append(torch.einsum("bhqs,bshd->bqhd", st, vf[:, :hi]))
        dens.append(st.sum(dim=-1).abs().transpose(1, 2))        # (B,q,H)
    num, den = torch.cat(nums, dim=1), torch.cat(dens, dim=1)
    den = torch.maximum(den, torch.exp(-m))
    return num / den[..., None]


def _mlstm_step(state: tuple, q0, k0, v0, li, lf) -> tuple:
    """One step of the recurrence: state ``(C, n, m)`` float32, ``q0``
    (B, H, hd), ``k0`` (scaled by hd^-½), ``v0`` float32, ``li`` / ``lf``
    (B, H).  Returns (the new state, h (B, H, hd))."""
    C_prev, n_prev, m_prev = state
    m_new = torch.maximum(lf + m_prev, li)
    i_s = torch.exp(li - m_new)
    f_s = torch.exp(lf + m_prev - m_new)
    C_new = (f_s[..., None, None] * C_prev
             + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", k0, v0))
    n_new = f_s[..., None] * n_prev + i_s[..., None] * k0
    num = torch.einsum("bhd,bhde->bhe", q0, C_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, q0).abs(),
                        torch.exp(-m_new))
    return (C_new, n_new, m_new), num / den[..., None]


def _qkv_gates(params: Params, conv_out: torch.Tensor,
               h_path: torch.Tensor, cfg: ModelConfig) -> tuple:
    """q, k (from the convolved path), v (B, S, H, hd) in the model dtype
    and the float32 gates log_i, log_f (B, S, H)."""
    _, d_in, H, hd = _mdims(cfg)
    B, S, _ = h_path.shape
    q = (conv_out @ params["wq"]).reshape(B, S, H, hd)
    k = (conv_out @ params["wk"]).reshape(B, S, H, hd)
    v = (h_path @ params["wv"]).reshape(B, S, H, hd)
    gates = h_path.float() @ params["w_gates"] + params["b_gates"]
    return q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:])


def mlstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Params] = None
          ) -> tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) -> (y (B, S, d), cache): the parallel form without a
    cache, a prefill with one and S > 1, one step of the recurrence at
    S = 1."""
    xx, d_in, H, hd = _mdims(cfg)
    B, S, _ = x.shape
    K = xx.conv_dim
    up = x @ params["up"]
    h_path, z = up[..., :d_in], up[..., d_in:]

    new_cache = None
    if cache is None or S > 1:
        if cache is not None:                                  # prefill
            if S < K - 1:
                raise ValueError(
                    f"an mLSTM prefill needs at least conv_dim − 1 = {K - 1}"
                    f" tokens to fill its convolution cache, got {S}")
            new_cache = {"conv": h_path[:, -(K - 1):]}
        conv_out = _causal_conv(h_path, params["conv_w"], params["conv_b"])
    else:
        window = torch.cat([cache["conv"], h_path], dim=1)    # (B, K, d_in)
        conv_out = (torch.einsum("bkc,kc->bc", window.float(),
                                 params["conv_w"].float())
                    + params["conv_b"].float())[:, None].to(x.dtype)
        new_cache = {"conv": window[:, 1:]}
    conv_out = F.silu(conv_out)
    q, k, v, log_i, log_f = _qkv_gates(params, conv_out, h_path, cfg)

    scale = hd ** -0.5
    if cache is None or S > 1:
        h = _mlstm_parallel(q, k, v, log_i, log_f)
        if new_cache is not None:        # prefill: the closed-form state
            Fc = torch.cumsum(log_f, dim=1)
            a = log_i - Fc                                      # (B,S,H)
            amax = a.max(dim=1).values                          # (B,H)
            w = torch.exp(a - amax[:, None])                    # (B,S,H)
            kf = k.float() * scale
            new_cache["C"] = torch.einsum("bshd,bshe->bhde",
                                          w[..., None] * kf, v.float())
            new_cache["n"] = torch.einsum("bsh,bshd->bhd", w, kf)
            new_cache["m"] = Fc[:, -1] + amax
    else:
        state, h = _mlstm_step(
            (cache["C"], cache["n"], cache["m"]), q[:, 0].float(),
            k[:, 0].float() * scale, v[:, 0].float(), log_i[:, 0],
            log_f[:, 0])
        new_cache.update(zip(("C", "n", "m"), state))

    h = h.reshape(B, S, d_in).to(x.dtype)
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    h = h * F.silu(z)
    return h @ params["down"], new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    f_ff = 2 * d
    dev = generator.device
    f32 = torch.float32
    return {
        "W": dense_init(generator, d, 4 * d, f32, lead),
        "R": _normal(generator, (H, hd, 4 * hd), (1.0 / hd) ** 0.5, f32,
                     lead),
        "b": _const(torch.cat([torch.zeros(2 * d, dtype=f32, device=dev),
                               torch.ones(d, dtype=f32, device=dev),
                               torch.zeros(d, dtype=f32, device=dev)]),
                    lead),
        "out_norm": torch.zeros(lead + (d,), dtype=dtype, device=dev),
        "ff_up": dense_init(generator, d, 2 * f_ff, dtype, lead),
        "ff_down": dense_init(generator, f_ff, d, dtype, lead),
    }


SLSTM_STATE = ("c", "n", "h", "m")


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device, lead: tuple[int, ...] = ()) -> Params:
    """The float32 state (B, d) each: ``c`` 0, ``n`` 1, ``h`` 0, ``m`` 0."""
    del dtype
    shape = lead + (batch, cfg.d_model)
    return {key: torch.full(shape, 1.0 if key == "n" else 0.0,
                            dtype=torch.float32, device=device)
            for key in SLSTM_STATE}


def _slstm_step(params: Params, cfg: ModelConfig, state: tuple,
                wx: torch.Tensor) -> tuple:
    """One sLSTM timestep.  wx (B, 4d) = W x_t + b; state c/n/h/m (B, d)."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    c, n, h, m = state
    B = wx.shape[0]
    rec = torch.einsum("bhp,hpq->bhq", h.reshape(B, H, hd), params["R"])
    pre = wx + rec.reshape(B, 4 * d)
    z_t = torch.tanh(pre[:, :d])
    i_t = pre[:, d: 2 * d]
    log_f = F.logsigmoid(pre[:, 2 * d: 3 * d])
    o_t = torch.sigmoid(pre[:, 3 * d:])
    m_new = torch.maximum(log_f + m, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z_t
    n_new = f_s * n + i_s
    h_new = o_t * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Params] = None
          ) -> tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) -> (y, cache): the recurrence over S steps from the
    cache's state (or the initial one), then the gated feed-forward."""
    B, S, d = x.shape
    wx = x.float() @ params["W"] + params["b"]
    if cache is None:
        state = tuple(init_slstm_cache(cfg, B, None, x.device).values())
    else:
        state = tuple(cache[key] for key in SLSTM_STATE)
    hs = []
    for t in range(S):
        state = _slstm_step(params, cfg, state, wx[:, t])
        hs.append(state[2])
    new_cache = None if cache is None else dict(zip(SLSTM_STATE, state))
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = rms_norm(h, params["out_norm"], cfg.norm_eps)
    up = h @ params["ff_up"]
    f_ff = params["ff_down"].shape[0]
    gate, val = up[..., :f_ff], up[..., f_ff:]
    return (activation(gate, "gelu") * val) @ params["ff_down"], new_cache
