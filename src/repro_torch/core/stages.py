"""The round stages (``repro.core.stages`` counterpart): the client update,
aggregation, orientation (what each client transmits toward the next ν)
and the server optimizer, and their composition into the tree layout's
synchronous and cohort rounds.

``Algorithm`` (core/fedopt.py) names a composition: ``algo.aggregator``,
``algo.selector`` and ``algo.server_opt`` index these registries.  Every
stage does the reference's float32 arithmetic in the reference's order and
returns values in the state's dtype; λ arrives as a host float.  The stages
after the local steps are tree-polymorphic: they act leaf by leaf
(``tree_util.tree_map``), so the flat layout (core/flat.py) calls them on
its ``(P,)`` / ``(M, P)`` buffers, one leaf each, and the tree layout on
the model's own leaves.

The tree layout's local steps (``make_client_update``) are plain torch per
leaf, as the reference's are jnp per leaf: every client's gradient in one
autograd pass over the vmapped loss, then ``x − η(g + λc)`` under the
reference's ``where(k < K_i, new, old)`` mask.  Compression, payload
attacks and the robust stage work on the wire rows of the flat view table
(``_flat_bridge``), as in the reference; the parameters stay a tree.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import compress
from repro_torch.core import robust as robust_mod
from repro_torch.core.fedopt import Algorithm
from repro_torch.core.tree_util import (expand, rows_dot, tree_leaves,
                                        tree_map, tree_wsum)

PyTree = Any


def _flat_bridge(spec):
    """Tree-layout access to the flat view table (the wire stages):
    ``(ravel, ravel_rows, unravel, unravel_rows)`` closures over ``spec``.
    Imported at build time: core/flat.py imports this module."""
    from repro_torch.core import flat as _flat
    return (lambda t: _flat.ravel(spec, t),
            lambda t: _flat.ravel(spec, t, client_dims=1),
            lambda a: _flat.unravel(spec, a),
            lambda a: _flat.unravel(spec, a, client_dims=1))


def _typed_scale(lam, c: torch.Tensor) -> torch.Tensor:
    """λ·c in c's dtype: a λ tensor of another dtype is cast first, so a
    bfloat16 state is never promoted; a host float multiplies in c's
    dtype."""
    if isinstance(lam, torch.Tensor) and lam.dtype != c.dtype:
        return lam.to(c.dtype) * c
    return lam * c


# ---------------------------------------------------------------------------
# stage 1: client update (tree layout)
# ---------------------------------------------------------------------------

def _rebuild(tree: PyTree, leaves) -> PyTree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_value_and_grad(loss_fn: Callable[[PyTree, PyTree], torch.Tensor]):
    """``vag(x, batch) -> (losses (M,), grads)`` for a tree ``x`` of ``(M,
    …)`` client leaves and ``batch`` with a leading client axis.
    ``torch.func.vmap`` batches the one-client loss over the client axis
    and one autograd pass differentiates the sum of the per-client losses:
    each client's loss depends only on its own rows, so row i of each leaf
    gradient is client i's gradient (the flat layout's
    ``flat_value_and_grad`` without the buffer)."""
    batched = torch.func.vmap(loss_fn)

    def run(x: PyTree, batch: PyTree):
        leaves = [lv.detach().requires_grad_() for lv in tree_leaves(x)]
        with torch.enable_grad():
            losses = batched(_rebuild(x, leaves), batch)
            grads = torch.autograd.grad(losses.sum(), leaves)
        return losses.detach(), _rebuild(x, grads)

    return run


def make_client_update(loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                       algo: Algorithm, *, lr: float, k_max: int,
                       track_nu: str = "delta",
                       per_client_anchor: bool = False):
    """The per-client local steps on the tree layout: ``f(anchor, c_all,
    batches, k_steps, lam) -> (x_i, g0_i, acc_i, loss0)``, each per-client
    value a tree of ``(M, …)`` leaves.  ``anchor`` is the model every
    client starts from, or with ``per_client_anchor=True`` a tree of
    ``(M, …)`` leaves, each client's (the buffered path's dispatch-time
    models, also the prox term's x₀).  ``c_all`` is the tree of
    corrections ν − ν⁽ⁱ⁾ (read only by ν algorithms), ``batches`` a dict of
    ``(M, k_max, …)`` tensors, ``k_steps`` the ``(M,)`` K_i.  ``g0_i`` is
    None unless the selector reads the first gradient; ``acc_i`` (the
    explicitly accumulated ν̄⁽ⁱ⁾, ``track_nu="explicit"``) None otherwise.

    Step asynchronism is masking: every client runs ``k_max`` steps and a
    step past K_i keeps the old leaves (``where(k < K_i, new, old)``, so
    a non-finite gradient of a masked step never reaches x), as in the
    reference's scan.  Plain torch per leaf: the flat layout's
    calibrated-update kernel is not used here."""
    needs_first = algo.selector in ("fedagrac", "first", "reverse")
    uses_nu = algo.uses_nu
    explicit = track_nu == "explicit" and uses_nu
    vag = tree_value_and_grad(loss_fn)

    def run(anchor: PyTree, c_all: PyTree, batches: dict,
            k_steps: torch.Tensor, lam):
        m = k_steps.shape[0]
        x = (anchor if per_client_anchor
             else tree_map(lambda a: a.expand((m,) + tuple(a.shape)),
                           anchor))
        lam_c = (tree_map(lambda c: _typed_scale(lam, c), c_all)
                 if uses_nu else None)
        acc = tree_map(torch.zeros_like, x) if explicit else None
        g0 = loss0 = None
        for k in range(k_max):
            loss, g = vag(x, {key: v[:, k] for key, v in batches.items()})
            if k == 0:
                loss0 = loss
            if algo.prox_mu:
                g = tree_map(lambda gg, xx, x0: gg + algo.prox_mu * (xx - x0),
                             g, x, anchor)
            active = k < k_steps                                  # (M,)

            def step(xx, gg, cc=None):
                t = gg * lr if cc is None else (gg + cc).mul_(lr)
                new = xx - t
                return torch.where(expand(active, new), new, xx)

            x = (tree_map(step, x, g, lam_c) if uses_nu
                 else tree_map(step, x, g))
            if k == 0 and needs_first:
                g0 = g
            if explicit:
                w = torch.where(active, 1.0 / k_steps.float(), 0.0)
                acc = tree_map(lambda a, gg: a + expand(w, gg) * gg, acc, g)
            del g
        return x, g0, acc, loss0

    return run


def zero_corrections(params: PyTree, m: int) -> PyTree:
    """Zero-size per-client correction placeholder for algorithms without
    ν: the client update's signature stays uniform."""
    return tree_map(lambda a: a.new_zeros((m,) + (0,) * a.dim()), params)


# ---------------------------------------------------------------------------
# stage 2: aggregation
# ---------------------------------------------------------------------------

def aggregate_mean(params0: PyTree, x_i: PyTree, kf: torch.Tensor,
                   weights: torch.Tensor, kbar: torch.Tensor,
                   dot=rows_dot) -> PyTree:
    """Plain weighted average  Σ ω_i x⁽ⁱ⁾ (``dot``: the client-dim sum, as
    in ``tree_wsum``; every aggregator takes one)."""
    return tree_wsum(weights, x_i, dot)


def aggregate_fednova(params0: PyTree, x_i: PyTree, kf: torch.Tensor,
                      weights: torch.Tensor, kbar: torch.Tensor,
                      dot=rows_dot) -> PyTree:
    """FedNova:  x̃ + K̄ Σ ω_i (x⁽ⁱ⁾ − x̃)/K_i  (Wang et al. 2020)."""
    def one(p0, xi):
        d = (xi.float() - p0[None]) / expand(kf, xi)
        return (p0 + kbar * dot(weights, d)
                ).to(p0.dtype)
    return tree_map(one, params0, x_i)


AGGREGATORS: dict[str, Callable] = {
    "mean": aggregate_mean,
    "fednova": aggregate_fednova,
}


def buffered_mean(params: PyTree, anchor_i: PyTree, x_i: PyTree,
                  kf: torch.Tensor, sweights: torch.Tensor,
                  kbar: torch.Tensor, dot=rows_dot) -> PyTree:
    """Pseudo-delta average  x + Σ_i w̃_i (x⁽ⁱ⁾ − anchorᵢ)  over ``(C, …)``
    rows (``anchor_i`` ``(C, …)`` or ``(1, …)``).  The weights are not
    renormalized: with Σ w̃ = 1 this is the synchronous weighted
    average."""
    def one(p, ai, xi):
        d = xi.float() - ai.float()
        return (p.float() + dot(sweights, d)
                ).to(p.dtype)
    return tree_map(one, params, anchor_i, x_i)


def buffered_fednova(params: PyTree, anchor_i: PyTree, x_i: PyTree,
                     kf: torch.Tensor, sweights: torch.Tensor,
                     kbar: torch.Tensor, dot=rows_dot) -> PyTree:
    """Pseudo-delta FedNova:  x + K̄ Σ_i w̃_i (x⁽ⁱ⁾ − anchorᵢ)/K_i."""
    def one(p, ai, xi):
        d = (xi.float() - ai.float()) / expand(kf, xi)
        return (p.float() + kbar * dot(sweights, d)
                ).to(p.dtype)
    return tree_map(one, params, anchor_i, x_i)


BUFFERED_AGGREGATORS: dict[str, Callable] = {
    "mean": buffered_mean,
    "fednova": buffered_fednova,
}


def delivered_weights(weights, k_eff, k_sched) -> np.ndarray:
    """Partial-work recovery weight rule (fed/scenarios.py): a mid-round
    dropout delivering k′ < K completed steps keeps its (FedNova-normalized)
    per-step direction but carries only the mass it earned, w̃ ← w̃ · k′/K
    — NOT renormalized, so lost work is lost mass.  float32 numpy: the
    host tables of a chunk (the reference's host mirror)."""
    frac = (np.asarray(k_eff).astype(np.float32)
            / np.maximum(np.asarray(k_sched).astype(np.float32),
                         np.float32(1.0)))
    return np.asarray(weights, np.float32) * frac


def nu_mass_mix(nu: PyTree, contrib: PyTree, mass: torch.Tensor) -> PyTree:
    """ν ← (1 − ρ) ν + (ρ/Σw̃)·Σ w̃ transmitᵢ with ρ = min(Σw̃, 1): keep ρ of
    the new signal, renormalized, so the mix stays convex when duplicate
    ids or Horvitz–Thompson weights push Σw̃ past 1; at Σw̃ = 1 it is the
    synchronous ν."""
    rho = torch.clamp(mass, max=1.0)
    return tree_map(lambda n, c: ((1.0 - rho) * n.float()
                                  + (rho / mass) * c.float()).to(n.dtype),
                    nu, contrib)


def last_occurrence(ids) -> "np.ndarray":
    """(B,) int64: for each position j of the host id array ``ids``, the
    position of the LAST occurrence of ``ids[j]`` — the occurrence the
    reference's scatter keeps when an id repeats (a fast client reporting
    twice into one buffer, a weighted cohort drawing a client twice).
    Rows taken at these positions carry, for a repeated id, the same row
    at every occurrence, so a device scatter of them writes one value
    whatever order its writes land in."""
    ids = np.asarray(ids)
    last = np.arange(len(ids), dtype=np.int64)
    seen: dict = {}
    for j in range(len(ids) - 1, -1, -1):
        last[j] = seen.setdefault(int(ids[j]), j)
    return last


def scatter_nu_rows(nu_i: PyTree, new_nu: PyTree, avg_g: PyTree,
                    ids: torch.Tensor, nu_decay: float = 0.0, *,
                    in_place: bool = False,
                    last: Optional[torch.Tensor] = None,
                    put: Optional[Callable] = None) -> PyTree:
    """Write the participants' fresh ν̄⁽ⁱ⁾ rows into the population-sized
    ``(M, …)`` store; the other rows first decay toward the new ν at
    ``nu_decay`` per round (their correction ν − ν⁽ⁱ⁾ → 0; 0 keeps them
    frozen).  ``ids`` is an int64 index tensor; where an id repeats,
    ``last`` (``last_occurrence`` of the host ids, on the device) makes
    every occurrence carry the last one's row, the one the reference
    keeps, so the write is the same whatever order the device makes it
    in.

    ``in_place=True`` updates ``nu_i``'s leaves themselves (``lerp_`` only
    when ``nu_decay > 0``, then ``index_copy_`` of the C rows) and returns
    them: for a caller that owns the state, whose store would otherwise be
    copied whole every round.  ``put(store, ids, rows)`` is the row write
    (default ``index_copy_``; a mesh's ``param_constraint.put_rows``)."""
    put = put or NoMesh.put_rows

    def one(store, nu, g):
        rows = (g if last is None else g.index_select(0, last)
                ).to(store.dtype)
        if in_place:
            if nu_decay:
                store.lerp_(nu.to(store.dtype), nu_decay)
            return put(store, ids, rows)
        out = (torch.lerp(store, nu.to(store.dtype), nu_decay) if nu_decay
               else store.clone())
        return put(out, ids, rows)
    return tree_map(one, nu_i, new_nu, avg_g)


# ---------------------------------------------------------------------------
# stage 3: orientation (transmit selection)
# ---------------------------------------------------------------------------

def quantize_int8(tree: PyTree) -> PyTree:
    """Per-client, per-leaf symmetric int8 fake-quantization of the
    transmitted orientation: scale = amax/127 over each client's part of a
    leaf, round half to even.  The divisor is a tensor: CUDA divides by a
    host scalar as a product with its reciprocal, an ulp away from the
    reference's division."""
    def q(a):
        af = a.float()
        amax = (af.abs().amax(dim=tuple(range(1, a.dim())), keepdim=True)
                if a.dim() > 1 else af.abs())
        scale = torch.clamp_min(amax / amax.new_tensor(127.0), 1e-12)
        return (torch.round(af / scale) * scale).to(a.dtype)
    return tree_map(q, tree)


def _select_avg(g0_i, avg_g, fast):
    return avg_g


def _select_first(g0_i, avg_g, fast):
    return g0_i


def _select_fedagrac(g0_i, avg_g, fast):
    """Fast clients (K_i > K̄) send the first stochastic gradient, slow
    clients the averaged gradient (paper §4.2)."""
    return tree_map(lambda f, a: torch.where(expand(fast, a), f, a),
                    g0_i, avg_g)


def _select_reverse(g0_i, avg_g, fast):
    return tree_map(lambda f, a: torch.where(expand(fast, a), a, f),
                    g0_i, avg_g)


SELECTORS: dict[str, Callable] = {
    "avg": _select_avg,
    "first": _select_first,
    "fedagrac": _select_fedagrac,
    "reverse": _select_reverse,
}


def fast_mask(kf: torch.Tensor, kbar: torch.Tensor) -> torch.Tensor:
    """K_i > K̄ with a tie tolerance: K_i are integers but K̄ is a float32
    dot whose summation order can leave it 1 ulp under an exact tie."""
    return kf > kbar + 1e-4 * torch.clamp(kbar, min=1.0)


def recover_avg_grad(params0: PyTree, x_i: PyTree, c_all: PyTree,
                     kf: torch.Tensor, lr: float, lam: float,
                     anchor_i: Optional[PyTree] = None) -> PyTree:
    """Delta recovery of the averaged local gradient (paper §4.2):
    ν̄⁽ⁱ⁾ = (x̃ − x⁽ⁱ⁾_{K_i}) / (η K_i) − λ c⁽ⁱ⁾.  ``anchor_i`` (``(B, …)``
    rows, each client's dispatch-time model) replaces the shared x̃ on the
    buffered-async path."""
    def one(a0, xi, ci):
        x0 = a0[None] if anchor_i is None else a0
        return ((x0.float() - xi.float()) / (lr * expand(kf, xi))
                - lam * ci.float()).to(a0.dtype)
    return tree_map(one, params0 if anchor_i is None else anchor_i, x_i,
                    c_all)


def orientation_transmit(algo: Algorithm, params0: PyTree, x_i: PyTree,
                         g0_i: PyTree, acc_i: PyTree, c_all: PyTree,
                         kf: torch.Tensor, kbar: torch.Tensor, lr: float,
                         lam: float, *, track_nu: str = "delta",
                         quantize_transmit: bool = False,
                         anchor_i: Optional[PyTree] = None):
    """Per-client (transmit, avg_g): what flows into the next global ν, and
    the local reference ν⁽ⁱ⁾ (Alg. 1 line 11 — always the averaged grad):
    the explicitly accumulated ``acc_i`` under ``track_nu="explicit"``,
    else the delta recovery (``anchor_i`` as in ``recover_avg_grad``).
    ``quantize_transmit`` int8-fake-quantizes the transmit per client and
    leaf (``quantize_int8``)."""
    avg_g = (acc_i if track_nu == "explicit"
             else recover_avg_grad(params0, x_i, c_all, kf, lr, lam,
                                   anchor_i))
    transmit = SELECTORS[algo.selector](g0_i, avg_g, fast_mask(kf, kbar))
    if quantize_transmit:
        transmit = quantize_int8(transmit)
    return transmit, avg_g


# ---------------------------------------------------------------------------
# stage 4: server optimizer (FedOpt, Reddi et al. 2021)
# ---------------------------------------------------------------------------

def _server_sgd(algo, state, params0, agg, delta, new_state):
    """server_opt="sgd", server_lr=1 reproduces plain averaging exactly."""
    lr = algo.server_lr
    if lr == 1.0:
        return agg
    return tree_map(lambda p, d: (p.float() + lr * d).to(p.dtype),
                    params0, delta)


def _server_momentum(algo, state, params0, agg, delta, new_state):
    """FedAvgM."""
    lr, b1 = algo.server_lr, algo.server_beta1
    m = tree_map(lambda mm, d: b1 * mm.float() + d, state["server_m"], delta)
    new_state["server_m"] = tree_map(lambda mm, p: mm.to(p.dtype), m,
                                     params0)
    return tree_map(lambda p, mm: (p.float() + lr * mm).to(p.dtype),
                    params0, m)


def _server_adam(algo, state, params0, agg, delta, new_state):
    """FedAdam."""
    lr, b1 = algo.server_lr, algo.server_beta1
    b2, eps = 0.999, 1e-8
    t = state["round"].float() + 1.0
    m = tree_map(lambda mm, d: b1 * mm.float() + (1 - b1) * d,
                 state["server_m"], delta)
    v = tree_map(lambda vv, d: b2 * vv.float() + (1 - b2) * d * d,
                 state["server_v"], delta)
    new_state["server_m"] = tree_map(lambda mm, p: mm.to(p.dtype), m,
                                     params0)
    new_state["server_v"] = tree_map(lambda vv, p: vv.to(p.dtype), v,
                                     params0)
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    return tree_map(lambda p, mm, vv: (p.float() + lr * (mm / bc1)
                                       / (torch.sqrt(vv / bc2) + eps)
                                       ).to(p.dtype), params0, m, v)


SERVER_OPTIMIZERS: dict[str, Callable] = {
    "sgd": _server_sgd,
    "momentum": _server_momentum,
    "adam": _server_adam,
}


def server_update(algo: Algorithm, state: dict, params0: PyTree,
                  agg: PyTree, new_state: dict) -> PyTree:
    """FedOpt server step on the round pseudo-gradient Δ = agg − x̃_t."""
    if algo.server_opt not in SERVER_OPTIMIZERS:
        raise ValueError(algo.server_opt)
    delta = tree_map(lambda a, p: a.float() - p.float(), agg, params0)
    return SERVER_OPTIMIZERS[algo.server_opt](algo, state, params0, agg,
                                              delta, new_state)


# ---------------------------------------------------------------------------
# composition: the tree layout's synchronous round
# ---------------------------------------------------------------------------

class NoMesh:
    """The ``param_constraint`` of a round on one device, which is what
    ``None`` means: every hook is the plain op.  A mesh's constraint
    (launch/train.py) overrides them:

    * ``constraint(tree, client_dims)`` places a round value at the
      reference's sites (the clients' models after the local steps, the
      new params, ν and ν⁽ⁱ⁾);
    * ``local_steps(client_update)`` runs the clients' local steps
      (``make_client_update``'s function) in the mesh's explicit region;
    * ``flat_value_and_grad(spec, loss_fn)`` is the flat layout's
      gradient there (None: core/flat.py's own);
    * ``rows_dot(w, a)`` is Σ_m w[m]·a[m] over the client dim;
    * ``take_rows`` / ``put_rows`` read and write rows of a ν⁽ⁱ⁾ store.

    The reference's ``spmd_axis_name`` has no ``torch.func.vmap``
    argument; the region a mesh's ``local_steps`` opens, each rank running
    its data slice's clients, is its counterpart."""

    def __call__(self, tree: PyTree, client_dims: int) -> PyTree:
        return tree

    def local_steps(self, client_update: Callable) -> Callable:
        return client_update

    def flat_value_and_grad(self, spec, loss_fn) -> Optional[Callable]:
        return None

    rows_dot = staticmethod(rows_dot)

    @staticmethod
    def take_rows(store: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return store.index_select(0, ids)

    @staticmethod
    def put_rows(store: torch.Tensor, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
        return store.index_copy_(0, ids, rows)


def as_constraint(param_constraint: Optional[NoMesh]) -> NoMesh:
    """``param_constraint``, or the plain ``NoMesh`` for None."""
    return NoMesh() if param_constraint is None else param_constraint


class _Wire:
    """The wire stages of a tree round, built once: compression,
    robust aggregation and a payload attack, all on the rows of the flat
    view table (``_flat_bridge``).  ``on`` is False when none is
    configured, and the round is then the unchanged one."""

    def __init__(self, compression, spec, robust, attack, uses_nu: bool):
        self.cs = compress.build_stages(compression, spec, uses_nu)
        self.rb = robust_mod.build_round_robust(robust, spec, uses_nu)
        self.atk = (attack if attack is not None
                    and attack.corrupts_payload else None)
        if self.atk is not None and spec is None:
            raise ValueError("payload-corruption scenarios require a "
                             "FlatSpec — the engines build one on both "
                             "param layouts")
        self.on = (self.cs is not None or self.rb is not None
                   or self.atk is not None)
        self.down = self.cs is not None and self.cs.down is not None
        self.up = self.cs is not None and self.cs.up is not None
        # the ν transmit crosses the view table only when a stage reads
        # its rows (a downlink codec alone leaves it as it is)
        self.nu_rows = self.up or self.rb is not None or self.atk is not None
        if self.on:
            self.rv, self.rvr, self.ur, self.urr = _flat_bridge(spec)
            self.n = spec.n

    def broadcast(self, state: dict, new_state: dict, uses_nu: bool):
        """(anchor, ν̂): what the clients start from — the compressed
        broadcast under a downlink codec, else the server's own."""
        if not self.down:
            return state["params"], (state["nu"] if uses_nu else None)
        cs = self.cs
        anchor = self.ur(cs.down(self.rv(state["params"]), state, new_state))
        nu_bc = (self.ur(cs.down_nu(self.rv(state["nu"]), state, new_state))
                 if uses_nu else None)
        return anchor, nu_bc


def make_layered_round(loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                       algo: Algorithm, *, lr: float, k_max: int,
                       track_nu: str = "delta",
                       quantize_transmit: bool = False,
                       compression=None, spec=None, robust=None,
                       attack=None,
                       param_constraint: Optional[NoMesh] = None):
    """The four stages composed into the tree layout's synchronous round:
    ``round_fn(state, batches, k_steps, weights, lam=None, *, noise=None)
    -> (state, metrics)`` on tree state (core/rounds.py ``init_state``),
    the signature of ``flat.make_flat_round``'s round.  ``batches`` holds
    ``(M, k_max, B, …)`` tensors, ``k_steps`` is ``(M,)`` integer and
    ``weights`` ``(M,)`` float32, on the state's device; ``lam`` a host
    float (default ``algo.lam``).

    ``compression`` (with the model's ``spec``) adds the wire stage as the
    reference's tree round does, through the flat view table: the
    broadcast codec turns params and ν into the anchor and ν̂ the clients
    start from, the uplink codecs compress each client's delta and ν
    transmit rows with their own error feedback, and with the broadcast
    on, the aggregate is re-based onto the true params.  ``attack`` and
    ``robust`` bracket the same wire: corruption of what each client puts
    on it, then the codec, then the defense; the guard keeps the old
    params, ν and ν⁽ⁱ⁾ wherever the new ones are non-finite, and the
    metrics hold ``quarantined``.  ``noise`` holds an attack's ``(2, M,
    P)`` noise rows (``Scenario.payload_noise``), else the attack draws
    them from the round counter.

    ``param_constraint(tree, client_dims)`` places round values on a mesh
    (launch/train.py's) at the reference's sites: the clients' models
    after the local steps, the new params, ν and ν⁽ⁱ⁾.  Its other hooks
    (``NoMesh``) run the local steps in the mesh's region and sum over the
    client dim.  ``None`` is the same computation as without the hook."""
    constrain = as_constraint(param_constraint)
    client_update = constrain.local_steps(make_client_update(
        loss_fn, algo, lr=lr, k_max=k_max, track_nu=track_nu))
    aggregate = AGGREGATORS[algo.aggregator]
    wire = _Wire(compression, spec, robust, attack, algo.uses_nu)
    cs, rb, atk = wire.cs, wire.rb, wire.atk

    def round_fn(state: dict, batches: dict, k_steps: torch.Tensor,
                 weights: torch.Tensor, lam: Optional[float] = None, *,
                 noise: Optional[torch.Tensor] = None):
        if lam is None:
            lam = algo.lam
        params0 = state["params"]
        m = k_steps.shape[0]
        kf = k_steps.float()
        kbar = torch.dot(weights, kf)
        new_state = dict(state)
        anchor, nu_bc = wire.broadcast(state, new_state, algo.uses_nu)
        c_all = (tree_map(lambda nu, nui: nu[None] - nui, nu_bc,
                          state["nu_i"])
                 if algo.uses_nu else zero_corrections(params0, m))
        x_i, g0_i, acc_i, loss0 = client_update(anchor, c_all, batches,
                                                k_steps, lam)
        x_i = constrain(x_i, 1)
        r = state["round"]
        ids = quar = None
        if rb is not None:
            ids = torch.arange(m, device=k_steps.device)
            quar = rb.quarantined(state, r, ids)

        # the uplink: the server sees x̂ᵢ = anchor + C(Δᵢ + eᵢ)
        w_agg = weights
        if wire.on:
            a_flat = wire.rv(anchor)
            d = wire.rvr(x_i) - a_flat[None]
            if atk is not None:
                d = atk.corrupt_delta(r, d, wire.n,
                                      noise=None if noise is None
                                      else noise[0])
            if wire.up:
                d = cs.up(d, state, new_state)
            if rb is not None:
                d, w_agg, qcount = rb.model(d, weights, state, new_state, r,
                                            ids, quar)
            x_srv = wire.urr(a_flat[None] + d)
        else:
            x_srv = x_i
        agg = aggregate(anchor, x_srv, kf, w_agg, kbar,
                        dot=constrain.rows_dot)
        if wire.down:
            # the pseudo-gradient is measured against the broadcast the
            # clients anchored on, then applied to the true server model
            agg = tree_map(lambda p0, a, an: (p0.float() + a.float()
                                              - an.float()).to(p0.dtype),
                           params0, agg, anchor)
        new_state["params"] = constrain(
            server_update(algo, state, params0, agg, new_state), 0)
        new_state["round"] = state["round"] + 1

        if algo.uses_nu:
            # avg_g (the client-local ν⁽ⁱ⁾) uses the true local iterate —
            # it never crosses the wire; the transmit does
            transmit, avg_g = orientation_transmit(
                algo, anchor, x_i, g0_i, acc_i, c_all, kf, kbar, lr, lam,
                track_nu=track_nu, quantize_transmit=quantize_transmit)
            w_nu = weights
            if wire.nu_rows:
                t_rows = wire.rvr(transmit)
                if atk is not None:
                    t_rows = atk.corrupt_nu(r, t_rows, wire.n,
                                            noise=None if noise is None
                                            else noise[1])
                if wire.up:
                    t_rows = cs.up_nu(t_rows, state, new_state)
                if rb is not None:
                    t_rows, w_nu = rb.nu(t_rows, weights, quar)
                transmit = wire.urr(t_rows)
            new_state["nu"] = constrain(
                tree_wsum(w_nu, transmit, constrain.rows_dot), 0)
            new_state["nu_i"] = constrain(avg_g, 1)

        if rb is not None:
            new_state["params"] = rb.guard(new_state["params"], params0)
            if algo.uses_nu:
                new_state["nu"] = rb.guard(new_state["nu"], state["nu"])
                new_state["nu_i"] = rb.guard(new_state["nu_i"],
                                             state["nu_i"])

        metrics = {"loss": torch.dot(weights, loss0), "kbar": kbar}
        if rb is not None:
            metrics["quarantined"] = qcount
        return new_state, metrics

    return round_fn


# ---------------------------------------------------------------------------
# composition: the tree layout's cohort round (partial participation)
# ---------------------------------------------------------------------------

def make_cohort_round(loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                      algo: Algorithm, *, lr: float, k_max: int,
                      nu_decay: float = 0.0, track_nu: str = "delta",
                      quantize_transmit: bool = False,
                      compression=None, spec=None, robust=None,
                      attack=None,
                      param_constraint: Optional[NoMesh] = None):
    """One round of a sampled cohort of C clients over population-sized
    tree state (each ν⁽ⁱ⁾ leaf ``(M, …)``): ``round_fn(state, batches,
    cohort, k_steps, cweights, lam=None, *, donate=False, last=None,
    noise=None)``, the signature of ``flat.make_flat_cohort_round``'s
    round.  ``cohort`` holds the ``(C,)`` int64 client ids, ``cweights``
    the renormalized w̃.

    The cohort's ν⁽ⁱ⁾ rows are gathered per leaf, the local steps run on
    the C clients, the aggregate is the pseudo-delta (Horvitz–Thompson)
    form ``x + Σ w̃_i (x⁽ⁱ⁾ − x̂)``, ν mass-mixes with ρ = min(Σw̃, 1) and
    the fresh rows scatter back (the rest decay toward ν at
    ``nu_decay``); ``last`` (``last_occurrence`` of a cohort that repeats
    an id) makes the write the last occurrence's.  The wire stages work
    at the cohort's ids as in ``make_layered_round``; ``donate=True``
    (the caller hands the state over) updates the ν⁽ⁱ⁾, error-feedback
    and health stores in place.  ``param_constraint`` as in
    ``make_layered_round``, at the reference's sites (the ν⁽ⁱ⁾ store
    after the scatter); its ``take_rows`` / ``put_rows`` read and write
    the store's rows."""
    constrain = as_constraint(param_constraint)
    client_update = constrain.local_steps(make_client_update(
        loss_fn, algo, lr=lr, k_max=k_max, track_nu=track_nu))
    aggregate = BUFFERED_AGGREGATORS[algo.aggregator]
    wire = _Wire(compression, spec, robust, attack, algo.uses_nu)
    cs, rb, atk = wire.cs, wire.rb, wire.atk

    def round_fn(state: dict, batches: dict, cohort: torch.Tensor,
                 k_steps: torch.Tensor, cweights: torch.Tensor,
                 lam: Optional[float] = None, *, donate: bool = False,
                 last: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None):
        if lam is None:
            lam = algo.lam
        params0 = state["params"]
        kf = k_steps.float()
        mass = cweights.sum()
        kbar = torch.dot(cweights, kf) / mass
        new_state = dict(state)
        anchor, nu_bc = wire.broadcast(state, new_state, algo.uses_nu)
        c_all = (tree_map(lambda nu, nui: nu[None] - constrain.take_rows(
                     nui, cohort), nu_bc, state["nu_i"])
                 if algo.uses_nu
                 else zero_corrections(params0, cohort.shape[0]))
        x_i, g0_i, acc_i, loss0 = client_update(anchor, c_all, batches,
                                                k_steps, lam)
        x_i = constrain(x_i, 1)
        r = state["round"]
        quar = rb.quarantined(state, r, cohort) if rb is not None else None
        w_agg = cweights
        if wire.on:
            a_flat = wire.rv(anchor)
            d = wire.rvr(x_i) - a_flat[None]
            if atk is not None:
                d = atk.corrupt_delta(r, d, wire.n, ids=cohort,
                                      noise=None if noise is None
                                      else noise[0])
            if wire.up:
                d = cs.up(d, state, new_state, ids=cohort, last=last,
                          in_place=donate)
            if rb is not None:
                d, w_agg, qcount = rb.model(d, cweights, state, new_state, r,
                                            cohort, quar, last=last,
                                            in_place=donate)
            x_srv = wire.urr(a_flat[None] + d)
        else:
            x_srv = x_i
        # deltas around the broadcast x̂, added to the true params
        agg = aggregate(params0, tree_map(lambda a: a[None], anchor), x_srv,
                        kf, w_agg, kbar, dot=constrain.rows_dot)
        new_params = constrain(
            server_update(algo, state, params0, agg, new_state), 0)
        if rb is not None:
            new_params = rb.guard(new_params, params0)
        new_state["params"] = new_params
        new_state["round"] = state["round"] + 1

        if algo.uses_nu:
            transmit, avg_g = orientation_transmit(
                algo, anchor, x_i, g0_i, acc_i, c_all, kf, kbar, lr, lam,
                track_nu=track_nu, quantize_transmit=quantize_transmit)
            w_nu = cweights
            if wire.nu_rows:
                t_rows = wire.rvr(transmit)
                if atk is not None:
                    t_rows = atk.corrupt_nu(r, t_rows, wire.n, ids=cohort,
                                            noise=None if noise is None
                                            else noise[1])
                if wire.up:
                    t_rows = cs.up_nu(t_rows, state, new_state, ids=cohort,
                                      last=last, in_place=donate)
                if rb is not None:
                    t_rows, w_nu = rb.nu(t_rows, cweights, quar)
                transmit = wire.urr(t_rows)
            new_nu = nu_mass_mix(
                state["nu"], tree_wsum(w_nu, transmit, constrain.rows_dot),
                mass)
            if rb is not None:
                # the guard, on ν and on the rows written into the store
                # (the decayed rows mix two finite rows)
                new_nu = rb.guard(new_nu, state["nu"])
                avg_g = robust_mod.guarded_rows(avg_g, state["nu_i"], cohort)
            new_state["nu"] = constrain(new_nu, 0)
            new_state["nu_i"] = constrain(scatter_nu_rows(
                state["nu_i"], new_nu, avg_g, cohort, nu_decay,
                in_place=donate, last=last, put=constrain.put_rows), 1)

        metrics = {"loss": torch.dot(cweights, loss0) / mass, "kbar": kbar,
                   "mass": mass}
        if rb is not None:
            metrics["quarantined"] = qcount
        return new_state, metrics

    return round_fn
