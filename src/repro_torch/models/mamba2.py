"""Mamba2 (state-space duality) block (``repro.models.mamba2`` counterpart):
the chunked-parallel scan for a prompt, the O(1)-state recurrence for one
token.

A prompt's SSD goes through ``ssd_scan_diff`` (``kernels/ssd_scan/ops.py``)
on either device, for inference and training alike: a CPU tensor takes
the plain ``ssd_chunked`` and its explicit chunked VJP, a CUDA tensor the
hand-written forward and backward kernels, which read the heads' ``x``
and the groups' B and C straight out of the convolution's output; under
the flat round's vmap one launch of each covers every client.  The single-token recurrence
stays plain torch, as the reference computes it outside any kernel.  The
reference's ``dist.constrain`` sharding hint stands at its site (nothing
without a mesh); sharded execution of this family waits for ROADMAP A15's
training half.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import constrain
from repro_torch.kernels.ssd_scan.ops import ssd_scan_diff
from repro_torch.models.layers import _normal, dense_init, rms_norm

Params = dict[str, Any]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_ch


def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    s, d_in, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    dev = generator.device
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh

    def const(values: torch.Tensor) -> torch.Tensor:
        return values.expand(lead + values.shape).clone()

    return {
        "in_proj": dense_init(generator, d, proj_out, dtype, lead),
        "conv_w": _normal(generator, (s.d_conv, conv_ch),
                          (1.0 / s.d_conv) ** 0.5, dtype, lead),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": const(torch.log(torch.arange(
            1, nh + 1, dtype=torch.float32, device=dev))),
        "D": torch.ones(lead + (nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (nh,), dtype=torch.float32,
                               device=dev),
        "norm": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, d_in, d, dtype, lead),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device, lead: tuple[int, ...] = ()) -> Params:
    """The last ``d_conv − 1`` raw convolution inputs (model dtype) and the
    SSD state ``(B, nh, head_dim, d_state)`` in float32."""
    s, d_in, nh, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x (B, S, C), w (K, C) -> (B, S, C),
    contiguous.  jax's convolution is a cross-correlation, as torch's is, so
    ``w[k]`` multiplies ``x[t − (K − 1) + k]`` with no flip."""
    K, C = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))                 # (B, C, S+K-1)
    out = F.conv1d(xp, w.to(x.dtype).t()[:, None, :], groups=C)
    return out.transpose(1, 2).contiguous() + b


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: ``logaddexp(v, 0)`` (``F.softplus`` turns into the
    identity above 20, which jax does not)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def mamba(params: Params, x: torch.Tensor, cfg: ModelConfig,
          cache: Optional[Params] = None
          ) -> tuple[torch.Tensor, Optional[Params]]:
    """x (B, S, d) -> (y (B, S, d), cache).  With a cache and S > 1 this is
    a prefill into an empty cache (the reference's contract: the scan
    starts from a zero state); with S = 1 one step of the recurrence."""
    s, d_in, nh, conv_ch = _dims(cfg)
    B_, S_, _ = x.shape
    G, N, P = s.n_groups, s.d_state, s.head_dim
    K = s.d_conv

    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: d_in + conv_ch]
    dt_raw = zxbcdt[..., d_in + conv_ch:]                     # (B,S,nh)

    new_cache = None
    if cache is None or S_ > 1:
        if cache is not None:                                 # prefill
            if S_ < K - 1:
                # the reference keeps xbc[:, -(K-1):], fewer rows than its
                # cache holds, and fails on the next decode step (ROADMAP
                # C10)
                raise ValueError(
                    f"a Mamba2 prefill needs at least d_conv − 1 = {K - 1} "
                    f"tokens to fill its convolution cache, got {S_}")
            new_cache = {"conv": xbc[:, -(K - 1):, :]}
        xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    else:
        window = torch.cat([cache["conv"], xbc], dim=1)       # (B, K, C)
        xbc = (torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float())
               + params["conv_b"].float())[:, None, :].to(x.dtype)
        new_cache = {"conv": window[:, 1:, :]}
    xbc = F.silu(xbc)

    xs = xbc[..., :d_in].reshape(B_, S_, nh, P)
    Bm = xbc[..., d_in: d_in + G * N].reshape(B_, S_, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B_, S_, G, N)
    xs = constrain(xs, "dp", None, "mp", None)

    dt = _softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])

    if cache is None or S_ > 1:
        y, S_last = ssd_scan_diff(xs, dt, A, Bm, Cm, s.chunk)
        if new_cache is not None:
            new_cache["ssm"] = S_last
    else:
        # single-step recurrence
        rep = nh // G
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1).float()   # (B,nh,N)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1).float()
        x0 = xs[:, 0].float()                                 # (B,nh,P)
        dt0 = dt[:, 0]                                        # (B,nh)
        decay = torch.exp(dt0 * A[None, :])                   # (B,nh)
        Snew = (decay[..., None, None] * cache["ssm"]
                + torch.einsum("bhp,bhn->bhpn", x0 * dt0[..., None], Bh))
        y = torch.einsum("bhn,bhpn->bhp", Ch, Snew)[:, None]
        new_cache["ssm"] = Snew
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(B_, S_, d_in).to(x.dtype)

    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm"],
                 cfg.norm_eps)
    return y @ params["out_proj"], new_cache
