"""Checked wrappers of the calibrated-update kernels, with launch counters.

``calibrated_update(x, g, c, eta, lam)`` and
``calibrated_update_prox(x, g, c, x0, eta, lam, mu)`` compute
``x − η_row (g + λc [+ μ(x − x₀)])`` on ``(rows, 128·k)`` matrices (see
``csrc/calibrated_update.cu`` for the contract).  A CPU tensor takes the
plain PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel on the current stream, or raises — nothing falls back.  Each wrapper
adds one to its entry of ``launches`` where it launches its kernel, and
nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.calibrated_update import ref

LANES = 128

launches = {"calibrated_update": 0, "calibrated_update_prox": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.library("calibrated_update")
    ptr, f32, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
    lib.calibrated_update.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, f32,
                                      ptr, i64, i64, ptr]
    lib.calibrated_update.restype = ctypes.c_int
    lib.calibrated_update_prox.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr,
                                           ptr, f32, f32, ptr, i64, i64, ptr]
    lib.calibrated_update_prox.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, eta: torch.Tensor, **operands) -> None:
    if x.dim() != 2 or x.shape[1] % LANES:
        raise ValueError(f"x must be (rows, {LANES}·k), got {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    for name, t in {"x": x, **operands}.items():
        if t is None and name == "c":
            continue
        if t is None:
            raise ValueError(f"{name} is required")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; "
                f"expected x's {tuple(x.shape)} {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if (eta.shape != (x.shape[0],) or eta.dtype != torch.float32
            or eta.device != x.device or not eta.is_contiguous()):
        raise ValueError(
            f"eta must be a contiguous ({x.shape[0]},) float32 tensor on "
            f"{x.device}, got {tuple(eta.shape)} {eta.dtype} on {eta.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def calibrated_update(x: torch.Tensor, g: torch.Tensor,
                      c: Optional[torch.Tensor], eta: torch.Tensor,
                      lam: float) -> torch.Tensor:
    """x − η_row (g + λc); ``c=None`` is a zero correction (not read)."""
    _check(x, eta, g=g, c=c)
    if x.device.type == "cpu":
        return ref.calibrated_update(x, g, c, eta, lam)
    out = torch.empty_like(x)
    rc = _kernels().calibrated_update(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), g.data_ptr(), _ptr(c),
        eta.data_ptr(), lam, out.data_ptr(), x.shape[0], x.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_launch_error(rc, "calibrated_update")
    launches["calibrated_update"] += 1
    return out


def calibrated_update_prox(x: torch.Tensor, g: torch.Tensor,
                           c: Optional[torch.Tensor], x0: torch.Tensor,
                           eta: torch.Tensor, lam: float,
                           mu: float) -> torch.Tensor:
    """x − η_row (g + λc + μ(x − x₀)); ``c=None`` is a zero correction."""
    _check(x, eta, g=g, c=c, x0=x0)
    if x.device.type == "cpu":
        return ref.calibrated_update_prox(x, g, c, x0, eta, lam, mu)
    out = torch.empty_like(x)
    rc = _kernels().calibrated_update_prox(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), g.data_ptr(), _ptr(c),
        x0.data_ptr(), eta.data_ptr(), lam, mu, out.data_ptr(), x.shape[0],
        x.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_launch_error(rc, "calibrated_update_prox")
    launches["calibrated_update_prox"] += 1
    return out
