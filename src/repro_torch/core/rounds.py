"""Round state and the synchronous round (``repro.core.rounds``
counterpart), on either layout: ``params`` is the model tree (the tree
layout) or its ``(P,)`` buffer (the flat layout, core/flat.py)."""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core import compress, flat, robust as robust_mod
from repro_torch.core.fedopt import Algorithm
from repro_torch.core.stages import NoMesh, make_layered_round
from repro_torch.core.tree_util import (tree_leaves, tree_stack_zeros,
                                        tree_zeros)

PyTree = Any


def init_state(params: PyTree, n_clients: int, algo: Algorithm,
               compression=None, spec=None,
               broadcast_carry: bool = False, robust=None) -> dict:
    """Server + client state around ``params`` (a tree, or the flat
    layout's ``(P,)`` buffer).  ν/ν⁽ⁱ⁾ start at zero: the first round runs
    plain (uncalibrated) local SGD, as in the paper, where ν⁽ⁱ⁾ = ∇f_i(x₁)
    is unknown before any gradient.  ν⁽ⁱ⁾ has a leading client axis of
    ``n_clients`` on every leaf.  ``round`` is an int32 device scalar, so
    no round reads the host.

    With an active ``compression`` (core/compress.py) the error-feedback
    accumulators are added as flat rows on BOTH layouts (the tree round
    compresses through the view table): ``(M, P)`` rows per uplink
    quantity, ``(P,)`` per broadcast quantity; ``spec`` (a ``FlatSpec``)
    gives P and the dtype.  ``broadcast_carry=True`` (the buffered-async
    engine) also adds, under downlink compression, the broadcast carry
    ``compress.BC_KEYS``: ``bc_params`` and (ν algorithms) ``bc_nu``, the
    last compressed broadcast as ``(P,)`` buffers, which each run fills with
    its t = 0 broadcast.  An active ``robust`` config with quarantine on
    (core/robust.py) adds the five ``(M,)`` health vectors."""
    device = tree_leaves(params)[0].device
    state = {"params": params,
             "round": torch.zeros((), dtype=torch.int32, device=device)}
    if algo.uses_nu:
        state["nu"] = tree_zeros(params)
        state["nu_i"] = tree_stack_zeros(params, n_clients)
    if algo.server_opt == "momentum":
        state["server_m"] = tree_zeros(params)
    elif algo.server_opt == "adam":
        state["server_m"] = tree_zeros(params)
        state["server_v"] = tree_zeros(params)
    if compression is not None and compression.active:
        if spec is None:
            raise ValueError("compression requires a FlatSpec (built on "
                             "both layouts by the engines)")
        compress.init_compression_state(state, compression, n_clients,
                                        spec.p, spec.dtype, algo.uses_nu)
        if broadcast_carry and compression.down_active:
            state["bc_params"] = (params.clone()
                                  if isinstance(params, torch.Tensor)
                                  else flat.ravel(spec, params))
            if algo.uses_nu:
                state["bc_nu"] = torch.zeros(spec.p, dtype=spec.dtype,
                                             device=device)
    robust_mod.init_robust_state(state, robust, n_clients)
    return state


def make_round(loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
               algo: Algorithm, *, lr: float, k_max: int,
               track_nu: str = "delta", quantize_transmit: bool = False,
               compression=None, spec=None, robust=None, attack=None,
               param_constraint: Optional[NoMesh] = None):
    """The tree layout's synchronous round, ``round_fn(state, batches,
    k_steps, weights, lam=None, *, noise=None) -> (state, metrics)``
    (``stages.make_layered_round``).  ``param_constraint(tree,
    client_dims)`` places round values on a mesh at the reference's
    sites (its other hooks: ``stages.NoMesh``); the reference's
    ``spmd_axis_name`` has no ``torch.func.vmap`` argument, and its
    counterpart is the region the constraint's ``local_steps`` opens."""
    return make_layered_round(
        loss_fn, algo, lr=lr, k_max=k_max, track_nu=track_nu,
        quantize_transmit=quantize_transmit, compression=compression,
        spec=spec, robust=robust, attack=attack,
        param_constraint=param_constraint)

