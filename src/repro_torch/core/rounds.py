"""Round state (``repro.core.rounds`` counterpart), flat layout only."""
from __future__ import annotations

import torch

from repro_torch.core import compress, robust as robust_mod
from repro_torch.core.fedopt import Algorithm


def init_state(params: torch.Tensor, n_clients: int, algo: Algorithm,
               compression=None, spec=None,
               broadcast_carry: bool = False, robust=None) -> dict:
    """Server + client state around the ``(P,)`` flat ``params``.  ν/ν⁽ⁱ⁾
    start at zero: the first round runs plain (uncalibrated) local SGD, as
    in the paper, where ν⁽ⁱ⁾ = ∇f_i(x₁) is unknown before any gradient.
    ``round`` is an int32 device scalar, so no round reads the host.

    With an active ``compression`` (core/compress.py) the error-feedback
    accumulators are added: ``(M, P)`` rows per uplink quantity, ``(P,)``
    per broadcast quantity; ``spec`` (a ``FlatSpec``) gives P and the
    dtype.  ``broadcast_carry=True`` (the buffered-async engine) also adds,
    under downlink compression, the broadcast carry ``compress.BC_KEYS``:
    ``bc_params`` and (ν algorithms) ``bc_nu``, the last compressed
    broadcast, which each run fills with its t = 0 broadcast.  An active
    ``robust`` config with quarantine on (core/robust.py) adds the five
    ``(M,)`` health vectors."""
    state = {"params": params,
             "round": torch.zeros((), dtype=torch.int32,
                                  device=params.device)}
    if algo.uses_nu:
        state["nu"] = torch.zeros_like(params)
        state["nu_i"] = params.new_zeros((n_clients,) + params.shape)
    if algo.server_opt == "momentum":
        state["server_m"] = torch.zeros_like(params)
    elif algo.server_opt == "adam":
        state["server_m"] = torch.zeros_like(params)
        state["server_v"] = torch.zeros_like(params)
    if compression is not None and compression.active:
        if spec is None:
            raise ValueError("compression requires a FlatSpec")
        compress.init_compression_state(state, compression, n_clients,
                                        spec.p, spec.dtype, algo.uses_nu)
        if broadcast_carry and compression.down_active:
            state["bc_params"] = params.clone()
            if algo.uses_nu:
                state["bc_nu"] = torch.zeros_like(params)
    robust_mod.init_robust_state(state, robust, n_clients)
    return state
