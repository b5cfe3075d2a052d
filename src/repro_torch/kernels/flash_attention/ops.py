"""Checked wrappers of the flash-attention kernels, with their launch
counters, on the model layout: q ``(B, Sq, H, Dqk)``, k ``(B, Skv, Hkv,
Dqk)``, v ``(B, Skv, Hkv, Dv)``.

* ``flash_attention_fwd`` returns ``(o (B, Sq, H, Dv), lse (B, H, Sq))``;
* ``flash_attention`` returns ``o`` (forward only);
* ``flash_attention_bwd`` returns ``(dq, dk, dv)`` from the forward's ``o``
  and ``lse`` and the cotangent ``do``: two kernels, ``dq`` and ``dk/dv``,
  after one plain reduction ``δ = rowsum(do ∘ o)``;
* ``flash_attention_diff`` returns ``o`` through ``FlashAttentionFn``, whose
  backward is ``flash_attention_bwd`` and which ``torch.func.vmap`` batches
  by folding the vmapped axis into B: one launch of each kernel covers
  every client of a vmapped loss (the training path, core/flat.py).

A CPU tensor takes the plain PyTorch versions (``ref.py``); a CUDA tensor
launches the hand-written kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) on the current stream, or raises — nothing
falls back.  ``launches`` gains one where a kernel is launched, and nowhere
else.
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
# keys a block of the dk/dv kernel takes, both dtypes (csrc/
# flash_attention_bwd.cu, BwdCfg::kKvBK and Tf32Cfg::kKvBK)
DKV_BLOCK_KEYS = 64

launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [i32, i32, ptr, ptr, ptr, ptr, ptr] + [i32] * 7 + [i64] * 9
        + [i32, i32, ctypes.c_float, ptr])
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_kernels() -> ctypes.CDLL:
    lib = _build.library("flash_attention_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv):
        fn.argtypes = ([i32, i32] + [ptr] * 9 + [i32] * 7 + [i64] * 12
                       + [i32, i32, ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
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


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def copy_width(*tensors: torch.Tensor) -> int:
    """The attention kernels' staging width in bytes: 16, 8 or 4 (a
    ``cp.async`` of that width; 2 = plain loads, bfloat16 only: a float32
    row start is a multiple of 4), the widest that divides
    every row start of the (B, S, H, D) ``tensors`` — each base address, and
    each of the batch, position and head strides in bytes whose dimension
    is longer than 1 (a stride of a size-1 dimension is never applied)."""
    width = 16
    for t in tensors:
        offsets = [t.data_ptr()] + [
            stride * t.element_size()
            for size, stride in zip(t.shape[:3], t.stride()[:3]) if size > 1]
        for off in offsets:
            while off % width:
                width //= 2
    return width


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal (+ sliding-window) attention with GQA, ``scale`` defaulting
    to ``Dqk ** -0.5``.  Returns ``o`` in q's dtype and ``lse`` float32."""
    _check(q, k, v, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref.attention_fwd(q, k, v, causal=causal, window=window,
                                 scale=scale)
    B, Sq, H, _ = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _kernels().flash_attention_fwd(
        _build.DTYPE_CODES[q.dtype], copy_width(q, k, v), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H,
        Hkv, Sq, Skv, q.shape[3], Dv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3],
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


def _check_bwd(q, k, v, do, rows, window) -> None:
    """``do`` (B, Sq, H, Dv) in q's dtype; ``rows``: the (B, H, Sq)
    float32 tensors (lse, and δ or o's stand-in) by name."""
    _check(q, k, v, window)
    B, Sq, H, _ = q.shape
    Dv = v.shape[3]
    if not isinstance(do, torch.Tensor) or do.shape != (B, Sq, H, Dv):
        raise ValueError(f"do must be (B, Sq, H, Dv) = {(B, Sq, H, Dv)}")
    if do.dtype != q.dtype or do.device != q.device:
        raise TypeError(f"do must be {q.dtype} on {q.device}")
    for name, t in rows.items():
        if (not isinstance(t, torch.Tensor) or t.shape != (B, H, Sq)
                or t.dtype != torch.float32 or t.device != q.device):
            raise ValueError(f"{name} must be float32 (B, H, Sq) = "
                             f"{(B, H, Sq)} on {q.device}")


@functools.cache
def _sm_count(index: int) -> int:
    """The SMs of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dkv_split(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the dk/dv kernel splits each GQA/MQA group (H > Hkv) over
    blocks, one per query head writing float32 partials that a second
    kernel sums in head order, rather than having one block loop over the
    group's g query heads: for both dtypes, when one block per (64-key
    tile, kv head, batch) would give fewer blocks than q's card has SMs —
    the MQA training shape (B 4, Skv 128, Hkv 1) gives 8.  Both sides of
    the rule were timed on an H100 80GB HBM3 (PERF.md §6): at 8 and 32
    such blocks the split was 3.0× and 2.2× faster in bfloat16, 6.4× and
    3.3× in float32; at 512 the loop was 3% and 34% faster in bfloat16,
    1% and 12% in float32 (it writes and reads no partials)."""
    B, H, Skv, Hkv = q.shape[0], q.shape[2], k.shape[1], k.shape[2]
    if H == Hkv:
        return False
    return B * Hkv * -(-Skv // DKV_BLOCK_KEYS) < _sm_count(q.device.index)


def dkv_workspace(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Optional[torch.Tensor]:
    """The dk/dv kernel's float32 scratch where ``dkv_split``: the
    partial dk (B, H, Skv, Dqk), then dv (B, H, Skv, Dv), flat; else
    ``None``."""
    if not dkv_split(q, k):
        return None
    B, _, H, D = q.shape
    return torch.empty(B * H * k.shape[1] * (D + v.shape[3]),
                       dtype=torch.float32, device=q.device)


def _bwd_launch(kernel: str, outs: tuple, q, k, v, do, lse, delta, causal,
                window, scale) -> None:
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    out0, out1 = (outs + (None,))[:2]
    ws = dkv_workspace(q, k, v) if out1 is not None else None
    rc = getattr(_bwd_kernels(), kernel)(
        _build.DTYPE_CODES[q.dtype], copy_width(q, k, v, do), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), out0.data_ptr(),
        None if out1 is None else out1.data_ptr(),
        None if ws is None else ws.data_ptr(), B, H, Hkv, Sq, Skv, D, Dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], int(causal), int(window),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on_launch_error(rc, kernel)
    launches[kernel] += 1


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor, *,
                           causal: bool = True, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel: ``dq (B, Sq, H, Dqk)`` in q's dtype, from the
    forward's float32 ``lse`` and ``delta = ref.row_delta(do, o)``."""
    _check_bwd(q, k, v, do, {"lse": lse, "delta": delta}, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref.attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                    window=window, scale=scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_attention_bwd_dq", (dq,), q, k, v, do, lse, delta,
                causal, window, scale)
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            scale: Optional[float] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel: ``(dk, dv)`` shaped and typed as ``(k, v)``, each
    summed over the query heads of its kv head."""
    _check_bwd(q, k, v, do, {"lse": lse, "delta": delta}, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref.attention_bwd_dkv(q, k, v, do, lse, delta,
                                     causal=causal, window=window,
                                     scale=scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _bwd_launch("flash_attention_bwd_dkv", (dk, dv), q, k, v, do, lse,
                delta, causal, window, scale)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of ``o = flash_attention(q, k, v)`` for
    the cotangent ``do`` (``(B, Sq, H, Dv)``, q's dtype), from the
    forward's ``o`` and float32 ``lse (B, H, Sq)``; each gradient has its
    input's shape and dtype.  On the card: δ, then one launch of each
    kernel."""
    _check_bwd(q, k, v, do, {"lse": lse}, window)
    if o.shape != do.shape or o.dtype != do.dtype or o.device != q.device:
        raise ValueError(f"o must be shaped and typed as do: "
                         f"{tuple(do.shape)} {do.dtype}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_cpu(q):
        return ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window, scale=scale)
    delta = ref.row_delta(do, o)
    kw = {"causal": causal, "window": window, "scale": scale}
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)


class FlashAttentionFn(torch.autograd.Function):
    """``(o, lse)`` of ``flash_attention_fwd`` with ``flash_attention_bwd``
    as its backward (``lse`` is not differentiable).  Under
    ``torch.func.vmap`` the ``vmap`` rule moves each input's vmapped axis
    to the front, folds it into B (expanding an input that is not
    vmapped) and calls the Function on the physical tensors, so each
    kernel runs once for the whole vmapped batch."""

    @staticmethod
    def forward(q, k, v, causal, window, scale):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   scale=scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.attrs = (causal, window, scale)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.attrs
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale):
        n = info.batch_size

        def fold(t, dim):
            t = (t.expand((n,) + t.shape) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape((n * t.shape[1],) + t.shape[2:])

        o, lse = FlashAttentionFn.apply(
            fold(q, in_dims[0]), fold(k, in_dims[1]), fold(v, in_dims[2]),
            causal, window, scale)
        return ((o.reshape((n, -1) + o.shape[1:]),
                 lse.reshape((n, -1) + lse.shape[1:])), (0, 0))


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable ``o (B, Sq, H, Dv)``: the forward kernel, and the dq
    and dk/dv kernels in autograd's backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttentionFn.apply(q, k, v, causal, window, scale)[0]
