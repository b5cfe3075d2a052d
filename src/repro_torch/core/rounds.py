"""Round state (``repro.core.rounds`` counterpart), flat layout only."""
from __future__ import annotations

import torch

from repro_torch.core.fedopt import Algorithm


def init_state(params: torch.Tensor, n_clients: int, algo: Algorithm) -> dict:
    """Server + client state around the ``(P,)`` flat ``params``.  ν/ν⁽ⁱ⁾
    start at zero: the first round runs plain (uncalibrated) local SGD, as
    in the paper, where ν⁽ⁱ⁾ = ∇f_i(x₁) is unknown before any gradient.
    ``round`` is an int32 device scalar, so no round reads the host."""
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
    return state
