"""Flat-parameter execution: the whole round state as one buffer
(``repro.core.flat`` counterpart).

Server vectors (params, ν, server moments) are ``(P,)`` tensors and
per-client state (ν⁽ⁱ⁾, the round's x⁽ⁱ⁾ and g₀⁽ⁱ⁾) ``(M, P)`` matrices, with
``P = ceil(n / 128) · 128`` and zeros in the pad tail ``[n, P)``.  Leaves
are laid out in ``jax.tree_util.tree_flatten`` order (dicts by sorted key:
``b, w`` for lr, ``b1, b2, w1, w2`` for the mlp; lists, such as an LM's
``params["segments"]``, by index), so a flat buffer means the same thing in
both packages.

Each local step runs the model on per-leaf views of the buffer
(``view_tree``: ``narrow`` + ``view``, no copies), takes every client's
gradient in one autograd pass, and applies the calibrated update with ONE
kernel launch on the whole ``(M, P)`` matrix
(``kernels/calibrated_update``).  The K_i mask is folded into the update as
a per-row step size η_i ∈ {η, 0}.  With a ``master_dtype`` the buffer is
float32 under bfloat16 leaves: the model computes in bfloat16 on views
cast at the boundary, and the updates apply to the float32 master.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.core import compress, stages
from repro_torch.core import robust as robust_mod
from repro_torch.core.fedopt import Algorithm
from repro_torch.core.tree_util import tree_wsum
from repro_torch.kernels.calibrated_update import ops as cu_ops
from repro_torch.kernels.quantize import ops as qops

LANES = cu_ops.LANES

PyTree = Any


# ---------------------------------------------------------------------------
# layout spec + ravel / unravel
# ---------------------------------------------------------------------------

def _leaves(tree: PyTree, path: tuple = ()) -> list:
    """[(key path, leaf)] in ``jax.tree_util.tree_flatten`` order: dicts by
    sorted key, lists and tuples by index, depth first.  A dict key and a
    list index are both path elements."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, child in enumerate(tree)
                for item in _leaves(child, path + (i,))]
    return [(path, tree)]


def _treedef(tree: PyTree):
    """The tree's containers with the leaves left out (hashable): a dict
    is ``("dict", ((key, def), …))`` by sorted key, a list or tuple
    ``("list" | "tuple", (def, …))``, a leaf ``None``."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _treedef(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_treedef(c) for c in tree))
    return None


def _build(node, it) -> PyTree:
    if node is None:
        return next(it)
    kind, children = node
    if kind == "dict":
        return {k: _build(c, it) for k, c in children}
    built = [_build(c, it) for c in children]
    return tuple(built) if kind == "tuple" else built


def _tree(treedef, leaves: list) -> PyTree:
    """Inverse of ``_leaves``: ``leaves`` in flatten order into the
    containers of ``treedef``.  (A module-level recursion: a nested
    recursive closure would form a reference cycle that keeps the leaves,
    views of a whole ``(M, P)`` buffer, alive until the garbage collector
    runs.)"""
    return _build(treedef, iter(leaves))


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static description of the tree ↔ flat-buffer bijection.

    ``n`` true elements, padded to ``p`` (a multiple of 128); ``dtype`` is
    the buffer dtype — the common leaf dtype, float32 for mixed leaves, or
    the explicit ``master_dtype`` (mixed precision: a float32 master
    buffer under bfloat16 leaves).
    ``(paths, offsets, shapes, dtypes, sizes)`` form the view table: leaf
    *i* is ``flat[…, offsets[i] : offsets[i] + sizes[i]]`` viewed as
    ``shapes[i]`` in ``dtypes[i]``; ``paths`` names each leaf by its keys
    and indices, and ``treedef`` holds the containers to rebuild."""
    paths: tuple
    treedef: Any
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    offsets: tuple
    n: int
    p: int
    dtype: torch.dtype


def make_flat_spec(tree: PyTree,
                   master_dtype: Union[str, torch.dtype, None] = None
                   ) -> FlatSpec:
    """The spec of ``tree``'s layout.  ``master_dtype`` sets the buffer
    dtype (the master copy all round state lives in) and leaves each
    leaf's view dtype as it is: bfloat16 leaves over a float32 master read
    bfloat16 views, and the updates apply at float32."""
    paths, leaves = zip(*_leaves(tree))
    shapes = tuple(tuple(lv.shape) for lv in leaves)
    dtypes = tuple(lv.dtype for lv in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    n = sum(sizes)
    p = -(-max(n, 1) // LANES) * LANES
    if master_dtype is not None:
        dtype = (master_dtype if isinstance(master_dtype, torch.dtype)
                 else getattr(torch, master_dtype))
    else:
        dtype = dtypes[0] if all(d == dtypes[0] for d in dtypes) \
            else torch.float32
    return FlatSpec(paths, _treedef(tree), shapes, dtypes, sizes, offsets,
                    n, p, dtype)


def ravel(spec: FlatSpec, tree: PyTree, client_dims: int = 0
          ) -> torch.Tensor:
    """Concat all leaves into a new ``(*lead, P)`` buffer — ``client_dims``
    leading axes are kept; the tail pads with zeros."""
    leaves = [lv for _, lv in _leaves(tree)]
    lead = tuple(leaves[0].shape[:client_dims])
    flat = leaves[0].new_zeros(lead + (spec.p,), dtype=spec.dtype)
    for lv, off, size in zip(leaves, spec.offsets, spec.sizes):
        flat[..., off:off + size] = lv.reshape(lead + (size,))
    return flat


def ravel_rows(spec: FlatSpec, tree: PyTree) -> torch.Tensor:
    """``ravel(spec, tree, client_dims=1)``: a tree of ``(M, …)`` leaves
    into ``(M, P)`` rows."""
    return ravel(spec, tree, client_dims=1)


def leaf_view(spec: FlatSpec, flat: torch.Tensor, i: int,
              client_dims: int = 0) -> torch.Tensor:
    """Leaf ``i`` as a view of the buffer at its view-table offset, in the
    leaf's dtype: no copy where that is the buffer dtype, one cast where
    it is not (a bfloat16 leaf of a float32 master)."""
    lead = tuple(flat.shape[:client_dims])
    return (flat.narrow(-1, spec.offsets[i], spec.sizes[i])
            .view(lead + spec.shapes[i]).to(spec.dtypes[i]))


def view_tree(spec: FlatSpec, flat: torch.Tensor, client_dims: int = 0
              ) -> PyTree:
    """The model tree as per-leaf views of the buffer (``leaf_view``)."""
    return _tree(spec.treedef, [leaf_view(spec, flat, i, client_dims)
                                for i in range(len(spec.sizes))])


def flat_cotangent(spec: FlatSpec, tree: PyTree, client_dims: int = 0
                   ) -> torch.Tensor:
    """Per-leaf cotangents (``client_dims`` leading axes) into ONE
    ``(*lead, P)`` buffer at the master dtype, each written into its
    view-table region with a zero pad tail: ``ravel``'s layout, the write
    half of the view table."""
    return ravel(spec, tree, client_dims)


def flat_apply(spec: FlatSpec, apply_fn: Callable,
               flat_params: torch.Tensor, *args, client_dims: int = 0,
               **kwargs):
    """``apply_fn(params_tree, *args, **kwargs)`` with ``params_tree`` the
    view table's leaves of ``flat_params``: a tree-signature model
    function run on the buffer."""
    return apply_fn(view_tree(spec, flat_params, client_dims), *args,
                    **kwargs)


def unravel(spec: FlatSpec, flat: torch.Tensor, client_dims: int = 0
            ) -> PyTree:
    """Inverse of ``ravel``: the tree as new tensors that own their data."""
    lead = tuple(flat.shape[:client_dims])
    leaves = [flat.narrow(-1, off, size).reshape(lead + shape)
              .to(dtype, copy=True)
              for off, size, shape, dtype in zip(spec.offsets, spec.sizes,
                                                 spec.shapes, spec.dtypes)]
    return _tree(spec.treedef, leaves)


def _passes_through(key: str) -> bool:
    """State keys that are the same on both layouts: the round counter,
    the compression rows (flat on both) and the ``(M,)`` health
    vectors."""
    return (key == "round" or key in compress.FLAT_STATE_KEYS
            or key in robust_mod.ROBUST_STATE_KEYS)


def flatten_state(spec: FlatSpec, state: dict) -> dict:
    """Tree round state into flat round state (same keys): params, ν and
    the server moments become ``(P,)`` buffers, ν⁽ⁱ⁾ ``(M, P)`` rows."""
    return {k: v if _passes_through(k)
            else ravel(spec, v, client_dims=int(k == "nu_i"))
            for k, v in state.items()}


def unflatten_state(spec: FlatSpec, state: dict) -> dict:
    """Inverse of ``flatten_state``."""
    return {k: v if _passes_through(k)
            else unravel(spec, v, client_dims=int(k == "nu_i"))
            for k, v in state.items()}


def flat_value_and_grad(spec: FlatSpec,
                        loss_fn: Callable[[PyTree, PyTree], torch.Tensor]):
    """``vag(rows, batch) -> (losses (M,), grads (M, P))`` for ``(M, P)``
    client rows, ``batch`` with a leading client axis.

    ``loss_fn`` is one client's loss; ``torch.func.vmap`` batches it over
    the client axis and one autograd pass differentiates the sum of the
    per-client losses.  Each client's loss depends only on its own row, so
    row *i* of the result is exactly client *i*'s gradient.  The gradient
    is taken with respect to the leaf views and written into one
    ``(M, P)`` buffer with a zero pad tail.  Under a ``master_dtype``
    (bfloat16 leaves, float32 master) the view cast is the only
    float32 → bfloat16 crossing, and each bfloat16 leaf gradient is
    widened into the float32 buffer, as in the reference's
    ``flat_value_and_grad``."""
    batched = torch.func.vmap(loss_fn)

    def run(rows: torch.Tensor, batch: PyTree):
        m = rows.shape[0]
        leaves = [rows.narrow(1, off, size).view((m,) + shape).to(dtype)
                  .detach().requires_grad_()
                  for off, size, shape, dtype in zip(
                      spec.offsets, spec.sizes, spec.shapes, spec.dtypes)]
        with torch.enable_grad():
            losses = batched(_tree(spec.treedef, leaves), batch)
            grads = list(torch.autograd.grad(losses.sum(), leaves))
        g = rows.new_empty((m, spec.p), dtype=spec.dtype)
        # each leaf gradient is copied into its view of g, whatever its
        # strides, and dropped at once: no reshaped temporaries, and the
        # leaf gradients and g overlap less at the peak
        for i, (off, size, shape) in enumerate(zip(
                spec.offsets, spec.sizes, spec.shapes)):
            g[:, off:off + size].view((m,) + shape).copy_(grads[i])
            grads[i] = None
        g[:, spec.n:] = 0
        return losses.detach(), g

    return run


# ---------------------------------------------------------------------------
# stage 1 (flat): the kernel-backed local steps
# ---------------------------------------------------------------------------

def make_flat_client_update(spec: FlatSpec,
                            loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                            algo: Algorithm, *, lr: float, k_max: int,
                            track_nu: str = "delta",
                            per_client_anchor: bool = False):
    """``f(anchor, c_all, batches, k_steps, lam) -> (x_i, g0_i, acc_i,
    loss0)`` on (M, P) rows (``stages.make_client_update``'s signature);
    ``c_all`` is ignored by algorithms without ν, ``g0_i`` is None unless
    the selector reads the first gradient, and ``acc_i`` None unless
    ``track_nu="explicit"`` accumulates ν̄⁽ⁱ⁾ = Σ_{k<K_i} g_k / K_i in the
    loop (a ν algorithm's; the delta recovery is the default).

    Every client runs ``k_max`` steps; client *i* applies updates only for
    ``k < K_i`` through its per-row η, and each step is ONE calibrated-update
    kernel launch on the whole matrix (the prox variant for FedProx-style
    algorithms).  ``anchor`` is the ``(P,)`` model every client starts
    from, or with ``per_client_anchor=True`` the contiguous ``(M, P)`` rows
    each client starts from (the buffered-async path's dispatch-time
    models), which are then also the prox term's x₀."""
    needs_first = algo.selector in ("fedagrac", "first", "reverse")
    uses_nu = algo.uses_nu
    explicit = track_nu == "explicit" and uses_nu
    # fusing the prox term into the kernel is valid only when nothing
    # downstream reads the gradient; a first-gradient selector and the
    # explicit ν accumulation do, and see the prox-augmented g as on the
    # reference's tree path
    fuse_prox = bool(algo.prox_mu) and not (needs_first or explicit)
    grad_fn = flat_value_and_grad(spec, loss_fn)

    def run(anchor: torch.Tensor, c_all: Optional[torch.Tensor],
            batches: dict, k_steps: torch.Tensor, lam: float):
        m = k_steps.shape[0]
        # the kernels return new tensors: per-client anchor rows are read,
        # never written
        x = (anchor if per_client_anchor
             else anchor[None].expand(m, spec.p).contiguous())
        # the prox term reads the (M, P) anchors at every step; without it
        # the starting rows are freed after the first update
        anchors = x if algo.prox_mu else None
        # ν-free algorithms pass no correction: the kernel then reads no c
        # (the same result as the reference's c = 0, λ = 0)
        lam_k = lam if uses_nu else 0.0
        c_k = c_all if uses_nu else None
        steps = torch.arange(k_max, device=k_steps.device)
        etas = torch.where(steps[:, None] < k_steps[None, :], lr, 0.0
                           ).to(torch.float32)                  # (k_max, M)
        g0, loss0, acc = None, None, None
        if explicit:
            acc = torch.zeros((m, spec.p), dtype=spec.dtype,
                              device=k_steps.device)
            # 1/K_i on the steps a client takes, 0 after (k_max, M)
            w_acc = torch.where(steps[:, None] < k_steps[None, :],
                                1.0 / k_steps.float()[None, :], 0.0)
        for k in range(k_max):
            loss, g = grad_fn(x, {key: v[:, k] for key, v in batches.items()})
            if k == 0:
                loss0 = loss
            if algo.prox_mu and not fuse_prox:
                g = g + algo.prox_mu * (x - anchors)
            if k == 0 and needs_first:
                g0 = g
            if fuse_prox:
                x = cu_ops.calibrated_update_prox(x, g, c_k, anchors, etas[k],
                                                  lam_k, algo.prox_mu)
            else:
                x = cu_ops.calibrated_update(x, g, c_k, etas[k], lam_k)
            if explicit:
                acc = acc + w_acc[k][:, None] * g
            del g           # not held through the next step's backward
        return x, g0, acc, loss0

    return run


def quantize_int8_flat(spec: FlatSpec, mat: torch.Tensor) -> torch.Tensor:
    """``stages.quantize_int8`` on ``(M, P)`` rows: the scale is per client
    and LEAF, so each view-table segment is quantized against its own
    row-wise amax (``qops.row_scales`` over the segment's columns), in the
    leaf's dtype, and written into its region of a new buffer whose pad
    tail is zero."""
    out = mat.new_zeros((mat.shape[0], spec.p), dtype=spec.dtype)
    for off, size, dtype in zip(spec.offsets, spec.sizes, spec.dtypes):
        af = mat[:, off:off + size].to(dtype).float()
        scale = qops.row_scales(af, size, 127)
        out[:, off:off + size] = (torch.round(af / scale) * scale).to(dtype)
    return out


def _flat_transmit(spec: FlatSpec, algo: Algorithm, params0, x_i, g0_i,
                   acc_i, c_all, kf, kbar, lr, lam, *,
                   track_nu: str = "delta", quantize_transmit: bool = False,
                   anchor_i=None):
    """``stages.orientation_transmit`` on flat rows, where the int8
    fake-quantization of ``quantize_transmit`` is ``quantize_int8_flat``'s
    (per leaf, as on the tree layout), not one scale a row."""
    transmit, avg_g = stages.orientation_transmit(
        algo, params0, x_i, g0_i, acc_i, c_all, kf, kbar, lr, lam,
        track_nu=track_nu, anchor_i=anchor_i)
    if quantize_transmit:
        transmit = quantize_int8_flat(spec, transmit)
    return transmit, avg_g


# ---------------------------------------------------------------------------
# composition: the flat synchronous round
# ---------------------------------------------------------------------------

def make_flat_round(spec: FlatSpec,
                    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                    algo: Algorithm, *, lr: float, k_max: int,
                    track_nu: str = "delta", quantize_transmit: bool = False,
                    compression: Optional[compress.CompressionConfig] = None,
                    robust: Optional[robust_mod.RobustConfig] = None,
                    attack=None):
    """``round_fn(state, batches, k_steps, weights, lam=None, *,
    noise=None) -> (state, metrics)`` on flat state (core/rounds.py
    ``init_state``).  ``batches``
    holds ``(M, k_max, B, …)`` tensors, ``k_steps`` is ``(M,)`` integer and
    ``weights`` ``(M,)`` float32, all on the state's device; ``lam`` is a
    host float (default ``algo.lam``).  The round never waits for the
    device: the returned state and metrics are device tensors.

    ``compression`` adds the wire stage (core/compress.py), as the
    reference's flat round does: the broadcast codec turns params and ν
    into the anchor x̂ and ν̂ the clients start from, the uplink codec
    compresses each client's delta x⁽ⁱ⁾ − x̂ and ν transmit, and with the
    broadcast on the aggregate is re-based onto the true params,
    x⁺ = x + (agg − x̂), so broadcast error never builds up in the server
    state.  ``None`` (or all "none") runs the unchanged round.

    ``attack`` (a payload-corrupting ``fed.scenarios.Scenario``) and
    ``robust`` (core/robust.py) bracket the same wire, as in the
    reference: each client's delta is corrupted, then goes through the
    uplink codec, then the defense (sanitize, quarantine, defend,
    renormalize the weights); the ν transmit likewise; and the guard keeps
    the old params, ν and ν⁽ⁱ⁾ wherever the new ones are non-finite.  The
    metrics then hold ``quarantined``, the count of quarantined reporters.
    ``noise`` holds the ``(2, M, P)`` device noise rows (delta, ν) of an
    attack that draws them (``Scenario.payload_noise``); without them the
    attack draws them on the host from the round counter.

    ``track_nu="explicit"`` takes ν̄⁽ⁱ⁾ from the local steps' accumulated
    gradients instead of the delta recovery; ``quantize_transmit`` int8
    fake-quantizes each client's ν transmit per leaf
    (``quantize_int8_flat``)."""
    client_update = make_flat_client_update(spec, loss_fn, algo, lr=lr,
                                            k_max=k_max, track_nu=track_nu)
    aggregate = stages.AGGREGATORS[algo.aggregator]
    cs = compress.build_stages(compression, spec, algo.uses_nu)
    rb = robust_mod.build_round_robust(robust, spec, algo.uses_nu)
    atk = attack if (attack is not None
                     and attack.corrupts_payload) else None
    wire = cs is not None or rb is not None or atk is not None
    down_on = cs is not None and cs.down is not None
    up_on = cs is not None and cs.up is not None

    def round_fn(state: dict, batches: dict, k_steps: torch.Tensor,
                 weights: torch.Tensor, lam: Optional[float] = None, *,
                 noise: Optional[torch.Tensor] = None):
        if lam is None:
            lam = algo.lam
        params0 = state["params"]                          # (P,)
        kf = k_steps.float()
        kbar = torch.dot(weights, kf)
        new_state = dict(state)

        if down_on:
            anchor = cs.down(params0, state, new_state)
            nu_bc = (cs.down_nu(state["nu"], state, new_state)
                     if algo.uses_nu else None)
        else:
            anchor = params0
            nu_bc = state["nu"] if algo.uses_nu else None

        c_all = (nu_bc[None] - state["nu_i"]
                 if algo.uses_nu else None)                # (M, P)
        x_i, g0_i, acc_i, loss0 = client_update(anchor, c_all, batches,
                                                k_steps, lam)
        r = state["round"]
        ids = quar = None
        if rb is not None:
            ids = torch.arange(x_i.shape[0], device=x_i.device)
            quar = rb.quarantined(state, r, ids)
        w_agg = weights
        if wire:
            d = x_i - anchor[None]
            if atk is not None:
                d = atk.corrupt_delta(r, d, spec.n,
                                      noise=None if noise is None
                                      else noise[0])
            if up_on:
                d = cs.up(d, state, new_state)
            if rb is not None:
                d, w_agg, qcount = rb.model(d, weights, state, new_state, r,
                                            ids, quar)
            x_srv = anchor[None] + d
        else:
            x_srv = x_i
        agg = aggregate(anchor, x_srv, kf, w_agg, kbar)
        if down_on:
            agg = (params0.float() + agg.float() - anchor.float()
                   ).to(spec.dtype)
        new_state["params"] = stages.server_update(algo, state, params0, agg,
                                                   new_state)
        new_state["round"] = state["round"] + 1

        if algo.uses_nu:
            transmit, avg_g = _flat_transmit(
                spec, algo, anchor, x_i, g0_i, acc_i, c_all, kf, kbar, lr,
                lam, track_nu=track_nu, quantize_transmit=quantize_transmit)
            w_nu = weights
            if atk is not None:
                transmit = atk.corrupt_nu(r, transmit, spec.n,
                                          noise=None if noise is None
                                          else noise[1])
            if up_on:
                transmit = cs.up_nu(transmit, state, new_state)
            if rb is not None:
                transmit, w_nu = rb.nu(transmit, weights, quar)
            new_state["nu"] = tree_wsum(w_nu, transmit)
            new_state["nu_i"] = avg_g

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
# composition: the flat cohort round (partial participation)
# ---------------------------------------------------------------------------

def make_flat_cohort_round(spec: FlatSpec,
                           loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                           algo: Algorithm, *, lr: float, k_max: int,
                           nu_decay: float = 0.0, track_nu: str = "delta",
                           quantize_transmit: bool = False,
                           compression: Optional[
                               compress.CompressionConfig] = None,
                           robust: Optional[robust_mod.RobustConfig] = None,
                           attack=None):
    """``round_fn(state, batches, cohort, k_steps, cweights, lam=None, *,
    donate=False, last=None, noise=None) -> (state, metrics)``: one round of a sampled
    cohort of C clients over population-sized state (``nu_i`` is ``(M,
    P)``).

    ``batches`` holds ``(C, k_max, B, …)`` tensors, ``cohort`` the ``(C,)``
    int64 client ids, ``k_steps`` ``(C,)`` integer and ``cweights`` the
    ``(C,)`` float32 renormalized weights w̃ (fed/population.py), all on
    the state's device.  The round gathers the cohort's ν⁽ⁱ⁾ rows into a
    fresh ``(C, P)`` correction, runs the local steps on the ``(C, P)``
    rows (one calibrated-update launch per step), aggregates in
    pseudo-delta form with w̃, takes the server step, mass-mixes ν with
    ρ = min(Σw̃, 1), and writes the cohort's fresh rows back into the
    store (the rest decay toward ν at ``nu_decay``).  Where an id repeats
    (the ``weighted`` sampler draws with replacement), ``last``
    (``stages.last_occurrence`` of the host cohort, on the device) makes
    every row written the last occurrence's, as the reference keeps.

    ``compression`` adds the wire stage as the reference's cohort round
    does: the broadcast codec gives the anchor x̂ and ν̂ the cohort starts
    from, the uplink codecs compress each client's delta x⁽ⁱ⁾ − x̂ and ν
    transmit with its own error-feedback rows, gathered and written back
    at the cohort's ids; the pseudo-delta aggregate is taken around x̂
    and added to the true params, so broadcast error never builds up in
    the server state.

    ``attack`` and ``robust`` bracket the wire as in ``make_flat_round``,
    at the cohort's ids: the quarantine reads and the health vectors are
    written at those ids (the repeated-id rule of core/robust.py), and the
    guard keeps the old ν⁽ⁱ⁾ elements wherever the cohort's fresh rows are
    non-finite.  ``noise`` holds the ``(2, C, P)`` noise rows of an attack
    that draws them.

    ``donate=True``: the caller hands the state over (a chunk that owns
    it, or a simulation replacing its own), and the ν⁽ⁱ⁾, error-feedback
    and health stores are updated in place instead of copied whole.
    ``track_nu`` and ``quantize_transmit`` as in ``make_flat_round``."""
    client_update = make_flat_client_update(spec, loss_fn, algo, lr=lr,
                                            k_max=k_max, track_nu=track_nu)
    aggregate = stages.BUFFERED_AGGREGATORS[algo.aggregator]
    cs = compress.build_stages(compression, spec, algo.uses_nu)
    rb = robust_mod.build_round_robust(robust, spec, algo.uses_nu)
    atk = attack if (attack is not None
                     and attack.corrupts_payload) else None
    wire = cs is not None or rb is not None or atk is not None
    down_on = cs is not None and cs.down is not None
    up_on = cs is not None and cs.up is not None

    def round_fn(state: dict, batches: dict, cohort: torch.Tensor,
                 k_steps: torch.Tensor, cweights: torch.Tensor,
                 lam: Optional[float] = None, *, donate: bool = False,
                 last: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None):
        if lam is None:
            lam = algo.lam
        params0 = state["params"]                          # (P,)
        kf = k_steps.float()
        mass = cweights.sum()
        kbar = torch.dot(cweights, kf) / mass
        new_state = dict(state)

        if down_on:
            anchor = cs.down(params0, state, new_state)
            nu_bc = (cs.down_nu(state["nu"], state, new_state)
                     if algo.uses_nu else None)
        else:
            anchor = params0
            nu_bc = state["nu"] if algo.uses_nu else None

        # a fresh contiguous (C, P) correction, never a view of the store
        c_all = (nu_bc[None] - state["nu_i"].index_select(0, cohort)
                 if algo.uses_nu else None)
        x_i, g0_i, acc_i, loss0 = client_update(anchor, c_all, batches,
                                                k_steps, lam)
        r = state["round"]
        quar = rb.quarantined(state, r, cohort) if rb is not None else None
        w_agg = cweights
        if wire:
            d = x_i - anchor[None]
            if atk is not None:
                d = atk.corrupt_delta(r, d, spec.n, ids=cohort,
                                      noise=None if noise is None
                                      else noise[0])
            if up_on:
                d = cs.up(d, state, new_state, ids=cohort, last=last,
                          in_place=donate)
            if rb is not None:
                d, w_agg, qcount = rb.model(d, cweights, state, new_state, r,
                                            cohort, quar, last=last,
                                            in_place=donate)
            x_srv = anchor[None] + d
        else:
            x_srv = x_i
        # the deltas are taken around the broadcast x̂ and added to the
        # true params: no re-base is needed
        agg = aggregate(params0, anchor[None], x_srv, kf, w_agg, kbar)
        new_params = stages.server_update(algo, state, params0, agg,
                                          new_state)
        if rb is not None:
            new_params = rb.guard(new_params, params0)
        new_state["params"] = new_params
        new_state["round"] = state["round"] + 1

        if algo.uses_nu:
            transmit, avg_g = _flat_transmit(
                spec, algo, anchor, x_i, g0_i, acc_i, c_all, kf, kbar, lr,
                lam, track_nu=track_nu, quantize_transmit=quantize_transmit)
            w_nu = cweights
            if atk is not None:
                transmit = atk.corrupt_nu(r, transmit, spec.n, ids=cohort,
                                          noise=None if noise is None
                                          else noise[1])
            if up_on:
                transmit = cs.up_nu(transmit, state, new_state, ids=cohort,
                                    last=last, in_place=donate)
            if rb is not None:
                transmit, w_nu = rb.nu(transmit, cweights, quar)
            new_nu = stages.nu_mass_mix(state["nu"],
                                        tree_wsum(w_nu, transmit), mass)
            if rb is not None:
                # the guard, on ν and on the rows written into the store
                # (the decayed rows mix two finite rows)
                new_nu = rb.guard(new_nu, state["nu"])
                avg_g = robust_mod.guarded_rows(avg_g, state["nu_i"], cohort)
            new_state["nu"] = new_nu
            new_state["nu_i"] = stages.scatter_nu_rows(
                state["nu_i"], new_nu, avg_g, cohort, nu_decay,
                in_place=donate, last=last)

        metrics = {"loss": torch.dot(cweights, loss0) / mass, "kbar": kbar,
                   "mass": mass}
        if rb is not None:
            metrics["quarantined"] = qcount
        return new_state, metrics

    return round_fn
