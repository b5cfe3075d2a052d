"""Mixture-of-Experts with top-k routing (``repro.models.moe`` counterpart).

Dispatch is the reference's sort-based capacity dispatch, step for step:
the (token, choice) assignments are sorted by expert id with a stable
sort, each assignment's place in its expert's queue is its sorted index
less the first index of its expert (``searchsorted``), and an expert
takes at most ``capacity = max(1, round(T·k / E · capacity_factor))``
tokens (Python's ``round``: halves to even).  Assignments past the
capacity go to a sink row ``E·C`` that reads back zeros.  Each expert
runs on its ``(C, d)`` buffer (``torch.bmm`` over the expert axis, as the
reference's einsums run outside any Pallas kernel), and the k outputs of
a token are gathered back through the inverse permutation and combined
in float32.

The dispatch is order-sensitive, as the reference's is (ROADMAP C19):
within an expert the token that comes first in flat ``(B, S)`` order
keeps its place, so when the capacity binds (a decode tick routes only
``T = slots`` tokens: capacity 1 for deepseek-v2-lite and granite) a
later slot's token loses that expert's share, and idle slots and prefill
pads are routed like any token.  The reference's ``dist.constrain``
hints on the (E, C, d) buffers stand at its sites (nothing without a
mesh); sharded execution of this family waits for ROADMAP A15's training
half.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import constrain
from repro_torch.models.layers import _normal, activation, dense_init
from repro_torch.models.mlp import init_mlp, mlp

Params = dict[str, Any]


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, lead: tuple[int, ...] = ()) -> Params:
    """The router (float32 in every model dtype, as the reference makes
    it), the stacked experts ``(E, d, f)`` / ``(E, f, d)`` drawn one
    expert at a time, and the shared experts as one MLP of width
    ``n_shared_experts · f``."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE configuration")
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.n_experts
    experts = lead + (E,)
    p = {
        "router": dense_init(generator, d, E, torch.float32, lead),
        "w_in": _normal(generator, (d, f), (1.0 / d) ** 0.5, dtype, experts),
        "w_out": _normal(generator, (f, d), (1.0 / f) ** 0.5, dtype,
                         experts),
    }
    if cfg.glu:
        p["w_gate"] = _normal(generator, (d, f), (1.0 / d) ** 0.5, dtype,
                              experts)
    if m.n_shared_experts:
        p["shared"] = init_mlp(generator, cfg, dtype,
                               d_ff=m.n_shared_experts * f, lead=lead)
    return p


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (weights (T, k), expert ids (T, k), aux loss).

    The logits are float32 against the float32 router; the top-k weights
    are renormalised to sum to one; the Switch-style load-balance loss
    counts each token's first choice only."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    E = router_w.shape[-1]
    me = probs.mean(dim=0)                                 # mean prob / expert
    # the one-hot of the first choices as a comparison: ``F.one_hot``
    # checks its input's values, which ``torch.func.vmap`` refuses
    first = top_ids[:, :1] == torch.arange(E, device=top_ids.device)
    ce = first.float().mean(dim=0)
    aux = E * (me * ce).sum()
    return top_p, top_ids, aux


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Tokens an expert takes from a call routing ``tokens`` tokens."""
    m = cfg.moe
    return int(max(1, round(tokens * m.top_k / m.n_experts
                            * m.capacity_factor)))


def dispatch(ids: torch.Tensor, C: int, E: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The capacity dispatch of ``ids`` (T, k): (``order``, the flat
    assignments sorted by expert; ``dst``, each sorted assignment's row of
    the ``(E·C + 1, d)`` buffer, the sink ``E·C`` where it is dropped)."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    pos = torch.arange(flat.numel(), device=ids.device) - first
    dst = torch.where(pos < C, sorted_ids * C + pos,
                      torch.full_like(pos, E * C))
    return order, dst


def moe(params: Params, x: torch.Tensor, cfg: ModelConfig
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux_loss · aux_loss_coef)."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE configuration")
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xt = x.reshape(T, d)
    weights, ids, aux = route(params["router"], xt, k)
    C = capacity(T, cfg)
    order, dst = dispatch(ids, C, E)

    # scatter the tokens into (E·C, d) buffers; row E·C is the dropped
    # assignments' sink
    buf = x.new_zeros((E * C + 1, d))
    buf[dst] = xt[torch.div(order, k, rounding_mode="floor")]
    buf = buf[:E * C].reshape(E, C, d)
    buf = constrain(buf, "mp", None, None)                 # all-to-all here

    h = torch.bmm(buf, params["w_in"])
    if cfg.glu:
        h = activation(torch.bmm(buf, params["w_gate"]), cfg.act) * h
    else:
        h = activation(h, cfg.act)
    out = torch.bmm(h, params["w_out"])                    # (E, C, d)
    out = constrain(out, "mp", None, None)
    out_flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])

    # assignment j of token t reads the row its sorted place was sent to
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    rows = out_flat[dst[inv]].reshape(T, k, d)
    y = torch.einsum("tkd,tk->td", rows.float(), weights.float()).to(x.dtype)
    if m.n_shared_experts:
        y = y + mlp(params["shared"], x, cfg).reshape(T, d)
    return y.reshape(B, S, d), aux * m.aux_loss_coef
