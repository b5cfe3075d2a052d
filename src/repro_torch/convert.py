"""Weights and round state carried across from the JAX package.

The caller hands over numpy arrays (``np.asarray`` of the JAX values), so
this module needs nothing of JAX.  LM parameter trees and KV caches keep
the reference's tree (``models/model.py``), so they cross as they are.  Flat buffers keep their layout: the port
lays leaves out in the same order with the same padding (core/flat.py), so
a JAX run's flat state resumes in the port as it is.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.core import compress, robust
from repro_torch.core.tree_util import tree_map

Device = Union[str, torch.device]

# the flat round state the port runs: (P,) server vectors, (M, P) ν⁽ⁱ⁾,
# the error-feedback accumulators of the compression stage, the
# buffered-async engine's broadcast carry and the quarantine's (M,) health
# vectors
FLAT_STATE_KEYS = ("params", "round", "nu", "nu_i", "server_m",
                   "server_v") + compress.FLAT_STATE_KEYS \
    + robust.ROBUST_STATE_KEYS


def tensor_from_numpy(a: Any, device: Device) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``, bit for bit;
    bfloat16 arrays (``ml_dtypes``) travel as their 16-bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree: Any, device: Device) -> Any:
    """A tree of dicts and lists of numpy arrays → the same tree of
    tensors, bit for bit."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def flat_state_from_numpy(state: dict, device: Device) -> dict:
    """A JAX flat round state (``param_layout="flat"``) as numpy arrays →
    the port's state: ``params``/``nu``/``server_m``/``server_v`` ``(P,)``,
    ``nu_i`` ``(M, P)``, the compression stage's ``ef_*`` accumulators, the
    async engine's ``bc_*`` broadcast carry, the quarantine's ``hz_*``
    health vectors and ``round`` an int32 scalar.  Raises on a key the
    port does not know."""
    unknown = sorted(set(state) - set(FLAT_STATE_KEYS))
    if unknown:
        raise NotImplementedError(
            f"state keys {unknown} belong to features the PyTorch port does "
            f"not run yet")
    out = {k: tensor_from_numpy(v, device) for k, v in state.items()}
    out["round"] = out["round"].to(torch.int32).reshape(())
    return out


def lm_params_from_numpy(tree: dict, device: Device) -> dict:
    """A JAX LM parameter tree (``repro.models.model.init_params``, numpy
    leaves, float32 or bfloat16) → the port's: ``{"segments": [...],
    "embed", "head"? / "heads"?, "final_norm"}`` with layer leaves stacked
    ``(n_groups, count, …)``, and for a hybrid stack ``"shared_attn"`` (one
    unstacked block) with ``{}`` for its segment.  Every leaf crosses bit
    for bit in its own dtype: an MoE block's float32 ``router`` beside
    bfloat16 experts stays float32, as do the xLSTM blocks' gate weights
    and biases (``w_gates``, ``b_gates``, ``W``, ``R``, ``b``); MLA's
    ``wq`` / ``w_kv_down`` / ``w_kv_up`` / ``ckv_norm`` and the audio front
    end's (K, V, d) ``embed`` and (K, d, V) ``heads`` cross like any
    weight.  Raises on a key the reference's trees do not have."""
    unknown = sorted(set(tree) - {"segments", "embed", "head", "heads",
                                  "final_norm", "shared_attn"})
    if unknown:
        raise NotImplementedError(
            f"parameter keys {unknown} are not keys of the reference's LM "
            f"trees")
    return params_from_numpy(tree, device)


def lm_caches_from_numpy(caches: list, device: Device) -> list:
    """A JAX cache list (``repro.models.model.init_caches`` or a prefill's
    output; one dict per segment, stacked ``(n_groups, count, B, …)``: an
    attention segment's ``k``/``v``/``pos``/``idx`` (a local layer's ring
    of ``sliding_window`` slots), an MLA segment's ``ckv``/``krope``/
    ``pos``/``idx``, a Mamba2 segment's ``conv`` (model dtype) and ``ssm``
    (float32) state, an mLSTM segment's ``conv`` (model dtype) and float32
    ``C`` / ``n`` / ``m`` (−inf before the first token), an sLSTM
    segment's float32 ``c`` / ``n`` / ``h`` / ``m``) → the port's, bit for
    bit."""
    return [params_from_numpy(c, device) for c in caches]
