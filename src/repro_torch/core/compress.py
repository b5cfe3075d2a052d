"""Wire compression as a round stage (``repro.core.compress`` counterpart,
DESIGN.md §14).

* ``COMPRESSORS`` — ``none`` / ``int8`` / ``int4`` / ``topk`` /
  ``topk+int8``, each a padding-masked fake-quant codec on the flat
  ``(rows, P)`` layout: the simulator runs compress → decompress in one
  program, and ``payload_bytes`` models the wire.  On a CUDA tensor every
  codec goes through the hand-written kernels of ``kernels/quantize``; on
  a CPU tensor through their plain versions.
* **Error feedback**: ê = C(v + e), e ← (v + e) − ê.  Per-client
  accumulators are ``(M, P)`` rows of the round state (``ef_up`` for the
  deltas, ``ef_nu`` for the ν transmits); the server broadcast keeps one
  ``(P,)`` accumulator per quantity (``ef_down``, ``ef_down_nu``): a
  broadcast is one compression event received by all.
* ``wire_cost`` / ``payload_bytes`` — the bytes model behind
  ``History.bytes_up`` / ``bytes_down``.

Every codec masks its input to the true n columns before any scale or
threshold reduction, so a poisoned lane-padding tail can neither inflate a
scale nor survive to the output.  ``compression=None`` (or an all-"none"
config) means no compression: ``make_flat_round`` then runs the unchanged
round.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core.tree_util import tree_leaves
from repro_torch.kernels.quantize import ops as qops

# int8: n code bytes + one 4-byte per-row scale.  int4: two codes per
# byte.  topk: k × (4-byte index + 4-byte value).  topk+int8: k × (4-byte
# index + 1-byte code) + scale.  fp32 ("none"): 4 bytes per element.
_QMAX = {"int8": 127, "int4": 7}


def payload_bytes(name: str, n: int, *, topk_frac: float = 0.05) -> float:
    """Wire bytes for ONE compressed length-n vector (scales included).
    ``round`` rounds half to even, as the reference's does."""
    if name == "none":
        return 4.0 * n
    if name == "int8":
        return float(n) + 4.0
    if name == "int4":
        return math.ceil(n / 2) + 4.0
    k = max(1, round(topk_frac * n))
    if name == "topk":
        return 8.0 * k
    if name == "topk+int8":
        return 5.0 * k + 4.0
    raise KeyError(f"unknown compressor {name!r}; valid options: "
                   f"{sorted(COMPRESSORS)}")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Build-time description of the round's compression stage."""
    uplink: str = "none"            # client → server deltas AND ν transmits
    downlink: str = "none"          # server → client (params, ν) broadcast
    error_feedback: bool = True
    topk_frac: float = 0.05

    @classmethod
    def from_fed(cls, fed) -> Optional["CompressionConfig"]:
        """None when the config asks for no compression at all: the
        round is then the unchanged one."""
        if fed.compressor == "none" and fed.broadcast_compressor == "none":
            return None
        return cls(uplink=fed.compressor,
                   downlink=fed.broadcast_compressor,
                   error_feedback=fed.error_feedback,
                   topk_frac=fed.topk_frac)

    @property
    def up_active(self) -> bool:
        return self.uplink != "none"

    @property
    def down_active(self) -> bool:
        return self.downlink != "none"

    @property
    def active(self) -> bool:
        return self.up_active or self.down_active


# ---------------------------------------------------------------------------
# codecs: fake-quant round trips on (rows, P)
# ---------------------------------------------------------------------------

def _mask_true(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero the lane-padding tail [n, P) — the codec's input mask; the
    scale and threshold reductions also mask inside ``qops``."""
    return torch.where(torch.arange(x.shape[-1], device=x.device) < n, x,
                       0.0)


def _make_int_codec(n: int, qmax: int) -> Callable:
    def codec(mat: torch.Tensor) -> torch.Tensor:
        xm = _mask_true(mat.float(), n)
        scale = qops.row_scales(xm, n, qmax)
        q = qops.quantize_2d(xm, scale, qmax=qmax)
        return qops.dequantize_2d(q, scale, out_dtype=mat.dtype)
    return codec


def _make_topk_codec(n: int, k: int) -> Callable:
    def codec(mat: torch.Tensor) -> torch.Tensor:
        xm = _mask_true(mat.float(), n)
        thresh = qops.topk_thresholds(xm, n, k)
        return qops.topk_mask_2d(xm, thresh).to(mat.dtype)
    return codec


def _make_topk_int8_codec(n: int, k: int) -> Callable:
    topk = _make_topk_codec(n, k)
    quant = _make_int_codec(n, _QMAX["int8"])

    def codec(mat: torch.Tensor) -> torch.Tensor:
        # sparsify first, then quantize the survivors: the int8 scale is
        # the largest SURVIVING magnitude, and zeroed entries code to 0
        return quant(topk(mat))
    return codec


def _codec_none(n, topk_frac):
    return lambda mat: mat


def _codec_int8(n, topk_frac):
    return _make_int_codec(n, _QMAX["int8"])


def _codec_int4(n, topk_frac):
    return _make_int_codec(n, _QMAX["int4"])


def _topk_k(n: int, topk_frac: float) -> int:
    return max(1, min(n, round(topk_frac * n)))


def _codec_topk(n, topk_frac):
    return _make_topk_codec(n, _topk_k(n, topk_frac))


def _codec_topk_int8(n, topk_frac):
    return _make_topk_int8_codec(n, _topk_k(n, topk_frac))


# name → factory(n, topk_frac) → codec(mat) -> mat
COMPRESSORS: dict[str, Callable] = {
    "none": _codec_none,
    "int8": _codec_int8,
    "int4": _codec_int4,
    "topk": _codec_topk,
    "topk+int8": _codec_topk_int8,
}


def make_codec(name: str, n: int, *, topk_frac: float = 0.05) -> Callable:
    """Fake-quant codec ``(rows, P) -> (rows, P)`` for compressor ``name``
    over vectors of n true elements (the P − n padding columns are masked
    out of every reduction and are zero on output)."""
    if name not in COMPRESSORS:
        raise KeyError(f"unknown compressor {name!r}; valid options: "
                       f"{sorted(COMPRESSORS)}")
    return COMPRESSORS[name](n, topk_frac)


# ---------------------------------------------------------------------------
# error-feedback stage closures (what make_flat_round bakes in)
# ---------------------------------------------------------------------------

def make_rows_stage(codec: Callable, error_feedback: bool,
                    key: str) -> Callable:
    """Uplink stage over per-client rows.  ``apply(rows, state, new_state,
    ids=None, *, last=None, in_place=False)`` compresses ``rows`` ``(B,
    P)`` with each reporting client's own accumulator — gathered at
    ``ids``, or the full ``(M, P)`` block when ids is None — and writes the
    new residuals back to THOSE rows only, so a client that did not report
    keeps its accumulator untouched.

    Where an id repeats (a client reporting twice into one buffer), each
    occurrence compresses with the accumulator it read, and the residual
    kept is the last occurrence's, as in the reference: ``last``
    (``stages.last_occurrence`` of the host ids, on the device) makes
    every occurrence write that one, so the write does not depend on the
    order the device makes it in.  ``in_place=True`` writes the rows into
    ``state[key]`` itself, for a caller that owns the state (the store is
    ``(M, P)``: a copy a round would cost its whole size)."""
    def apply(rows, state, new_state, ids=None, *, last=None,
              in_place=False):
        if error_feedback:
            ef = state[key]
            tgt = rows + (ef if ids is None else ef.index_select(0, ids))
            out = codec(tgt)
            resid = (tgt - out).to(ef.dtype)
            if ids is None:
                new_state[key] = resid
            else:
                if last is not None:
                    resid = resid.index_select(0, last)
                store = ef if in_place else ef.clone()
                new_state[key] = store.index_copy_(0, ids, resid)
            return out
        return codec(rows)
    return apply


def make_vector_stage(codec: Callable, error_feedback: bool,
                      key: str) -> Callable:
    """Downlink (broadcast) stage over one ``(P,)`` server vector with a
    single server-side accumulator."""
    def apply(vec, state, new_state):
        if error_feedback:
            tgt = vec + state[key]
            out = codec(tgt[None])[0]
            new_state[key] = (tgt - out).to(state[key].dtype)
            return out
        return codec(vec[None])[0]
    return apply


def init_compression_state(state: dict, compression: CompressionConfig,
                           n_clients: int, p: int, dtype: torch.dtype,
                           uses_nu: bool) -> None:
    """Allocate the error-feedback accumulators into the round state, on
    the device of ``state["params"]``: ``(M, P)`` rows per uplink quantity,
    ``(P,)`` per broadcast quantity.  A key exists iff error feedback is on
    for an active direction — ``make_flat_round`` gates on the same
    predicate."""
    if not compression.error_feedback:
        return
    device = tree_leaves(state["params"])[0].device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if compression.up_active:
        state["ef_up"] = zeros(n_clients, p)
        if uses_nu:
            state["ef_nu"] = zeros(n_clients, p)
    if compression.down_active:
        state["ef_down"] = zeros(p)
        if uses_nu:
            state["ef_down_nu"] = zeros(p)


@dataclasses.dataclass(frozen=True)
class RoundCompression:
    """What ``make_flat_round`` bakes in: one stage closure per transmitted
    quantity (None = that direction uncompressed).  ``up``/``up_nu`` are
    row stages with separate accumulators (the delta and the ν transmit
    are different wire quantities); ``down``/``down_nu`` are broadcast
    vector stages."""
    config: CompressionConfig
    up: Optional[Callable]
    up_nu: Optional[Callable]
    down: Optional[Callable]
    down_nu: Optional[Callable]


def build_stages(compression: Optional[CompressionConfig], spec,
                 uses_nu: bool) -> Optional[RoundCompression]:
    """Resolve a ``CompressionConfig`` against a ``FlatSpec`` into stage
    closures, or None when compression is off (``make_flat_round`` then
    runs the unchanged round)."""
    if compression is None or not compression.active:
        return None
    if spec is None:
        raise ValueError("compression requires a FlatSpec")
    ef = compression.error_feedback
    up = up_nu = down = down_nu = None
    if compression.up_active:
        codec = make_codec(compression.uplink, spec.n,
                           topk_frac=compression.topk_frac)
        up = make_rows_stage(codec, ef, "ef_up")
        if uses_nu:
            up_nu = make_rows_stage(codec, ef, "ef_nu")
    if compression.down_active:
        codec = make_codec(compression.downlink, spec.n,
                           topk_frac=compression.topk_frac)
        down = make_vector_stage(codec, ef, "ef_down")
        if uses_nu:
            down_nu = make_vector_stage(codec, ef, "ef_down_nu")
    return RoundCompression(compression, up, up_nu, down, down_nu)


EF_KEYS = ("ef_up", "ef_nu", "ef_down", "ef_down_nu")
# the buffered-async engine's broadcast carry (fed/async_engine.py): the
# last compressed server broadcast, kept in the state so that chunk
# boundaries and resumes see the anchors the clients were dispatched with
BC_KEYS = ("bc_params", "bc_nu")
FLAT_STATE_KEYS = EF_KEYS + BC_KEYS


# ---------------------------------------------------------------------------
# bytes-on-the-wire accounting
# ---------------------------------------------------------------------------

def wire_cost(n: int, uses_nu: bool,
              compression: Optional[CompressionConfig]) -> dict:
    """Per-client wire bytes per round under the configured compressors.
    The uplink carries the parameter delta plus (ν algorithms) the selected
    orientation transmit; the downlink the model broadcast plus (ν
    algorithms) the global ν.  The fp32 baseline is 4n per quantity.
    Multiply by the round's participant count for round totals, as the
    simulation does for ``History.bytes_up`` / ``bytes_down``."""
    up_name = compression.uplink if compression is not None else "none"
    down_name = compression.downlink if compression is not None else "none"
    frac = compression.topk_frac if compression is not None else 0.05
    q = 2 if uses_nu else 1
    up = q * payload_bytes(up_name, n, topk_frac=frac)
    down = q * payload_bytes(down_name, n, topk_frac=frac)
    return {"uplink_per_client": up, "downlink_per_client": down,
            "uplink_fp32_per_client": q * 4.0 * n,
            "downlink_fp32_per_client": q * 4.0 * n}


def bytes_on_the_wire(n_params: int, *, uses_nu: bool = True,
                      compressor: str = "none",
                      broadcast_compressor: str = "none",
                      topk_frac: float = 0.05,
                      participants: int = 1, rounds: int = 1) -> dict:
    """The analytic wire-traffic model of a federated run: ``wire_cost``'s
    per-client payloads, totals over ``participants`` reports × ``rounds``,
    and the reduction factors against fp32 (the measured
    ``History.bytes_up`` / ``bytes_down`` series are pinned against it)."""
    comp = (None if compressor == "none" and broadcast_compressor == "none"
            else CompressionConfig(uplink=compressor,
                                   downlink=broadcast_compressor,
                                   topk_frac=topk_frac))
    per = wire_cost(n_params, uses_nu, comp)
    scale = float(participants) * float(rounds)
    return {
        **per,
        "uplink_total": scale * per["uplink_per_client"],
        "downlink_total": scale * per["downlink_per_client"],
        "uplink_reduction": (per["uplink_fp32_per_client"]
                             / per["uplink_per_client"]),
        "downlink_reduction": (per["downlink_fp32_per_client"]
                               / per["downlink_per_client"]),
    }
