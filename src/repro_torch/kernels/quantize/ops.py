"""Checked wrappers of the wire-compression kernels, with launch counters,
and the per-row scalar selection that the reference keeps outside its
kernels (``src/repro/kernels/quantize/ops.py``).

``quantize_2d(x, scale, qmax=…)``, ``dequantize_2d(q, scale,
out_dtype=…)`` and ``topk_mask_2d(x, thresh)`` work on ``(rows, 128·k)``
matrices with a ``(rows, 1)`` float32 scale or threshold (see
``csrc/quantize.cu`` for the contract).  A CPU tensor takes the plain
PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel on the current stream, or raises — nothing falls back.  Each
wrapper adds one to its entry of ``launches`` where it launches its kernel,
and nowhere else.

The selection helpers are plain torch ops on either device:

* ``masked_abs_rowmax`` — max |x| per row over the true columns ``[0, n)``
  only, so a poisoned lane-padding tail can never inflate a scale;
* ``row_scales`` — the int8/int4 scale ``max(amax / qmax, eps)``;
* ``topk_thresholds`` — the k-th largest |x| per row, with the pad forced
  to −1 so that it can never take a top-k slot (``torch.topk``, as the
  reference's ``lax.top_k`` is outside its kernels too).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize import ref

LANES = 128

launches = {"quantize_2d": 0, "dequantize_2d": 0, "topk_mask_2d": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.library("quantize")
    ptr, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
    lib.quantize_2d.argtypes = [ctypes.c_int, ptr, ptr, f32, ptr, i64, i64,
                                ptr]
    lib.dequantize_2d.argtypes = [ctypes.c_int, ptr, ptr, ptr, i64, i64, ptr]
    lib.topk_mask_2d.argtypes = [ctypes.c_int, ptr, ptr, ptr, i64, i64, ptr]
    for fn in (lib.quantize_2d, lib.dequantize_2d, lib.topk_mask_2d):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, dtypes, row: torch.Tensor,
           row_name: str) -> None:
    """``x`` a contiguous ``(rows, 128·k)`` matrix of one of ``dtypes``,
    ``row`` its contiguous ``(rows, 1)`` float32 scalar operand."""
    if x.dim() != 2 or x.shape[1] % LANES:
        raise ValueError(f"{name} must be (rows, {LANES}·k), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {sorted(map(str, dtypes))}, "
                        f"got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if (row.shape != (x.shape[0], 1) or row.dtype != torch.float32
            or row.device != x.device or not row.is_contiguous()):
        raise ValueError(
            f"{row_name} must be a contiguous ({x.shape[0]}, 1) float32 "
            f"tensor on {x.device}, got {tuple(row.shape)} {row.dtype} on "
            f"{row.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_2d(x: torch.Tensor, scale: torch.Tensor, *,
                qmax: int = 127) -> torch.Tensor:
    """int8 codes ``clip(round(x / s), −qmax, qmax)`` (int4: qmax = 7 in
    the same container); ``scale`` ``(rows, 1)`` float32 > 0."""
    _check("x", x, _build.DTYPE_CODES, scale, "scale")
    if not 0 < qmax <= 127:
        raise ValueError(f"qmax must be in [1, 127], got {qmax}")
    if x.device.type == "cpu":
        return ref.quantize_2d(x, scale, qmax)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    rc = _kernels().quantize_2d(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(),
        float(qmax), q.data_ptr(), x.shape[0], x.shape[1], _stream(x))
    _build.raise_on_launch_error(rc, "quantize_2d")
    launches["quantize_2d"] += 1
    return q


def dequantize_2d(q: torch.Tensor, scale: torch.Tensor, *,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q · s`` in ``out_dtype`` (float32 or bfloat16)."""
    _check("q", q, (torch.int8,), scale, "scale")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if q.device.type == "cpu":
        return ref.dequantize_2d(q, scale, out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    rc = _kernels().dequantize_2d(
        _build.DTYPE_CODES[out_dtype], q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), q.shape[0], q.shape[1], _stream(q))
    _build.raise_on_launch_error(rc, "dequantize_2d")
    launches["dequantize_2d"] += 1
    return out


def topk_mask_2d(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """``x · 1[|x| ≥ t]`` per row, in ``x.dtype``: ties survive, so a row
    may keep more than k elements (the wire model charges exactly k)."""
    _check("x", x, _build.DTYPE_CODES, thresh, "thresh")
    if x.device.type == "cpu":
        return ref.topk_mask_2d(x, thresh)
    out = torch.empty_like(x)
    rc = _kernels().topk_mask_2d(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), thresh.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], _stream(x))
    _build.raise_on_launch_error(rc, "topk_mask_2d")
    launches["topk_mask_2d"] += 1
    return out


# -- scalar selection (outside the streaming kernels) ------------------------

def _true_columns(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(x.shape[-1], device=x.device) < n


def masked_abs_rowmax(x: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, P) → (rows, 1) float32: max |x| over columns [0, n) only —
    the pad [n, P) is excluded by construction, not assumed zero."""
    a = torch.where(_true_columns(x, n), x.float().abs(), 0.0)
    return a.amax(dim=-1, keepdim=True)


def row_scales(x: torch.Tensor, n: int, qmax: int,
               eps: float = 1e-12) -> torch.Tensor:
    """Per-row symmetric quantization scale ``max(amax / qmax, eps)``.
    The divisor is a tensor on x's device: CUDA divides a tensor by a host
    scalar as a product with its reciprocal, which can differ from the
    reference's division by one ulp."""
    amax = masked_abs_rowmax(x, n)
    return torch.clamp_min(amax / amax.new_tensor(float(qmax)), eps)


def topk_thresholds(x: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """(rows, P) → (rows, 1) float32: the k-th largest |x| per row over the
    true columns; pad magnitudes are forced to −1, below any real |x|.
    Requires 1 ≤ k ≤ n."""
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n={n}], got {k}")
    mag = torch.where(_true_columns(x, n), x.float().abs(), -1.0)
    top = torch.topk(mag, k, dim=-1).values
    return top[..., k - 1:k].contiguous()
