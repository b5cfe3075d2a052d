"""Checked wrappers of the flash-attention forward kernel, with its launch
counter, on the model layout: q ``(B, Sq, H, Dqk)``, k ``(B, Skv, Hkv,
Dqk)``, v ``(B, Skv, Hkv, Dv)``.

* ``flash_attention_fwd`` returns ``(o (B, Sq, H, Dv), lse (B, H, Sq))``;
* ``flash_attention`` returns ``o`` (the serving path's prefill).

A CPU tensor takes the plain PyTorch version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``csrc/flash_attention.cu``) on the
current stream, or raises — nothing falls back.  ``launches`` gains one
where the kernel is launched, and nowhere else.  The kernel has no
backward yet (ROADMAP B7): on the card, a call whose inputs require a
gradient under autograd raises instead of returning an output that autograd
would treat as a constant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

MAX_HEAD_DIM = 256
MAX_GRID_DIM = 65535                 # CUDA's limit on grid.y (H), grid.z (B)

launches = {"flash_attention_fwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [i32, ptr, ptr, ptr, ptr, ptr] + [i32] * 7 + [i64] * 9
        + [i32, i32, ctypes.c_float, ptr])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d (B, S, H, D) tensor")
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or v.shape[0] != B:
        raise ValueError(f"batch sizes differ: {q.shape}, {k.shape}, "
                         f"{v.shape}")
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"share (B, Skv, Hkv)")
    if k.shape[3] != D:
        raise ValueError(f"q and k head dims differ: {D} vs {k.shape[3]}")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H = {H} is not a multiple of Hkv = {Hkv}")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must be in [1, {MAX_HEAD_DIM}], got "
                         f"{D} and {v.shape[3]}")
    if min(B, Sq, k.shape[1]) < 1:
        raise ValueError("B, Sq and Skv must be at least 1")
    if B > MAX_GRID_DIM or H > MAX_GRID_DIM or max(Sq, k.shape[1]) >= 2**31:
        raise ValueError(f"shape out of the kernel's range: q {q.shape}, "
                         f"k {k.shape}")
    if window < 0:
        raise ValueError(f"window must be ≥ 0, got {window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal (+ sliding-window) attention with GQA, ``scale`` defaulting
    to ``Dqk ** -0.5``.  Returns ``o`` in q's dtype and ``lse`` float32."""
    _check(q, k, v, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.attention_fwd(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention backward kernels are not ported yet "
            "(ROADMAP B7): the card runs attention forward only")
    B, Sq, H, _ = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _kernels().flash_attention_fwd(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, Hkv, Sq, Skv,
        q.shape[3], Dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_launch_error(rc, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Forward only: ``o (B, Sq, H, Dv)``."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale)[0]
