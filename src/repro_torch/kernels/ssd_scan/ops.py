"""Checked wrapper of the SSD scan kernel, with its launch counter, in the
model layer's calling convention (``ssd_chunked(x, dt, A, B, C, chunk)``):
x ``(b, l, h, p)``, dt ``(b, l, h)`` float32 post-softplus, A ``(h,)``
float32 negative, B and C ``(b, l, g, n)`` with ``h % g == 0``.  Returns
``(y (b, l, h, p) float32, state (b, h, p, n) float32)``.

A CPU tensor takes the plain version (``ref.ssd_chunked``); a CUDA tensor
launches the hand-written kernel (``csrc/ssd_scan.cu``) on the current
stream — a memset of its chunk chain's flags, then one kernel, every chunk
a block — or raises: nothing falls back.  The kernel reads x, B and C in
place through their strides (a slice of the convolution's output, the
groups unrepeated), so nothing is copied before it.  It has no backward
yet: under autograd a CUDA call raises ``NotImplementedError`` (ROADMAP B9)
instead of detouring through the plain version.  ``launches`` gains one
where the kernel is launched, and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

MAX_DIM = 128                     # the kernel's largest P, N and chunk

launches = {"ssd_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.library("ssd_scan")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = ([i32] + [ptr] * 7 + [i32] * 7 + [i64] * 12
                                 + [ptr, ptr])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


def _check(x, dt, A, B, C, chunk) -> int:
    """Validate the operands; returns the chunk length ``L = min(chunk, l)``
    of the reference's contract."""
    named = (("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("B", B, 4),
             ("C", C, 4))
    for name, t, dim in named:
        if not isinstance(t, torch.Tensor) or t.dim() != dim:
            raise ValueError(f"{name} must be a {dim}-d tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share a dtype, got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} and "
                        f"{A.dtype}")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, l, h) or tuple(A.shape) != (h,):
        raise ValueError(f"dt must be (b, l, h) = {(b, l, h)} and A (h,), "
                         f"got {tuple(dt.shape)} and {tuple(A.shape)}")
    if B.shape != C.shape or tuple(B.shape[:2]) != (b, l):
        raise ValueError(f"B and C must be (b, l, g, n) with (b, l) = "
                         f"{(b, l)}, got {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    if min(b, l, h, p, g, n) < 1 or h % g:
        raise ValueError(f"h = {h} must be a multiple of g = {g}, every "
                         f"size at least 1")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    L = min(chunk, l)
    if l % L:
        raise ValueError(f"l = {l} is not a multiple of the chunk length "
                         f"L = min(chunk, l) = {L}")
    return L


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: ``(y, final state)``, both float32."""
    L = _check(x, dt, A, B, C, chunk)
    if _on_cpu(x):
        return ref.ssd_chunked(x, dt, A, B, C, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "the SSD backward is not ported to the card yet (ROADMAP B9): "
            "run the SSD scan under torch.inference_mode(), or on CPU "
            "tensors")
    return _launch(x, dt, A, B, C, L)


def _launch(x, dt, A, B, C, L: int) -> tuple[torch.Tensor, torch.Tensor]:
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if p > MAX_DIM or n > MAX_DIM or L > MAX_DIM:
        raise ValueError(f"the kernel takes p, n and the chunk length "
                         f"≤ {MAX_DIM}, got p = {p}, n = {n}, L = {L}")
    if b * h * (l // L) >= 2**31 or l >= 2**31:
        raise ValueError(f"shape out of the kernel's range: x "
                         f"{tuple(x.shape)}")
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    # the kernel's chain: a ticket counter and one flag per (b, h), zeroed
    # by the C entry before the launch
    flags = torch.empty(1 + b * h, dtype=torch.int32, device=x.device)
    rc = _kernels().ssd_scan_fwd(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        state.data_ptr(), b, l, h, p, g, n, L, *x.stride()[:3],
        *dt.stride(), *B.stride()[:3], *C.stride()[:3], flags.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_launch_error(rc, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, state
