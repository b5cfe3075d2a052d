"""Checked wrappers of the SSD scan kernels, with their launch counters, in
the model layer's calling convention (``ssd_chunked(x, dt, A, B, C,
chunk)``): x ``(b, l, h, p)``, dt ``(b, l, h)`` float32 post-softplus, A
``(h,)`` float32 negative — or ``(b, h)``, one row per batch row — B and C
``(b, l, g, n)`` with ``h % g == 0``.

* ``ssd_scan`` returns ``(y (b, l, h, p) float32, state (b, h, p, n)
  float32, entering)``: with ``states=True`` on the card, ``entering``
  holds the states entering each chunk (the backward reads them), else it
  is ``None``;
* ``ssd_scan_bwd`` returns ``(dx, ddt, dA, dB, dC)`` for the cotangents
  ``dy`` and ``dS_last``: four kernels (``csrc/ssd_scan_bwd.cu``);
* ``ssd_scan_diff`` returns ``(y, state)`` through ``SSDScanFn``, whose
  backward is ``ssd_scan_bwd`` and which ``torch.func.vmap`` batches by
  folding the vmapped axis into b (A into ``(n·b, h)``): one launch of
  each kernel covers every client of a vmapped loss.

A CPU tensor takes the plain versions (``ref.ssd_chunked``,
``ref.ssd_chunked_bwd``); a CUDA tensor launches the hand-written kernels
(``csrc/ssd_scan.cu``: a memset of its chunk chain's flags, then one
kernel, every chunk a block) on the current stream, or raises: nothing
falls back.  The kernels read x, B and C in place through their strides (a
slice of the convolution's output, the groups unrepeated), so nothing is
copied before them.  ``launches`` gains one where a kernel is launched,
and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

MAX_DIM = 128                     # the kernels' largest P, N and chunk

BWD_KERNELS = ("ssd_bwd_dstate", "ssd_bwd_chain", "ssd_bwd_chunk",
               "ssd_bwd_reduce")
launches = {"ssd_scan": 0, **{name: 0 for name in BWD_KERNELS}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.library("ssd_scan")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = ([i32] + [ptr] * 7 + [i32] * 7 + [i64] * 13
                                 + [ptr, ptr, ptr])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


# the C entries' common argument list (csrc/ssd_scan_bwd.cu SSD_BWD_ARGS):
# the dtype code, these tensors, then the sizes, the strides and the stream
BWD_TENSORS = ("x", "dt", "A", "B", "C", "dy", "dS_last", "states", "final",
               "gs", "decay", "dx", "ddt", "dBh", "dCh", "dA_chunks", "dB",
               "dC", "dA")


@functools.cache
def _bwd_kernels() -> ctypes.CDLL:
    lib = _build.library("ssd_scan_bwd")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in BWD_KERNELS:
        fn = getattr(lib, name)
        fn.argtypes = ([i32] + [ptr] * len(BWD_TENSORS) + [i32] * 8
                       + [i64] * 13 + [ptr])
        fn.restype = ctypes.c_int
    return lib


def _check(x, dt, A, B, C, chunk) -> int:
    """Validate the operands; returns the chunk length ``L = min(chunk, l)``
    of the reference's contract."""
    named = (("x", x, (4,)), ("dt", dt, (3,)), ("A", A, (1, 2)),
             ("B", B, (4,)), ("C", C, (4,)))
    for name, t, dims in named:
        if not isinstance(t, torch.Tensor) or t.dim() not in dims:
            raise ValueError(f"{name} must be a {dims[0]}-d tensor")
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
    if tuple(dt.shape) != (b, l, h) or tuple(A.shape) not in ((h,), (b, h)):
        raise ValueError(f"dt must be (b, l, h) = {(b, l, h)} and A (h,) or "
                         f"(b, h), got {tuple(dt.shape)} and "
                         f"{tuple(A.shape)}")
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


def _check_kernel_range(x, B, L: int) -> None:
    b, l, h, p = x.shape
    n = B.shape[3]
    if p > MAX_DIM or n > MAX_DIM or L > MAX_DIM:
        raise ValueError(f"the kernel takes p, n and the chunk length "
                         f"≤ {MAX_DIM}, got p = {p}, n = {n}, L = {L}")
    if b * h * (l // L) >= 2**31 or l >= 2**31:
        raise ValueError(f"shape out of the kernel's range: x "
                         f"{tuple(x.shape)}")


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _a_stride(A: torch.Tensor) -> int:
    """A's batch stride for the kernels: 0 for one A (h,)."""
    return 0 if A.dim() == 1 else A.stride(0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int, *,
             states: bool = False) -> tuple:
    """The chunked SSD scan: ``(y, final state, entering)``, y and the
    state float32; ``entering`` is ``None`` unless ``states`` is set on
    the card, where the kernel writes the states entering each chunk to it,
    ``(b, l // L, h, p, n)`` float32 (on the CPU the plain backward
    recomputes them)."""
    L = _check(x, dt, A, B, C, chunk)
    if _on_cpu(x):
        return (*ref.ssd_chunked(x, dt, A, B, C, chunk), None)
    return _launch(x, dt, A, B, C, L, states)


def _launch(x, dt, A, B, C, L: int, states: bool):
    """The forward kernel: ``(y, state, entering)``, ``entering`` the
    states entering each chunk with ``states``, else ``None``."""
    _check_kernel_range(x, B, L)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = (torch.empty((b, l // L, h, p, n), dtype=torch.float32,
                            device=x.device) if states else None)
    # the kernel's chain: a ticket counter and one flag per (b, h), zeroed
    # by the C entry before the launch
    flags = torch.empty(1 + b * h, dtype=torch.int32, device=x.device)
    rc = _kernels().ssd_scan_fwd(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        state.data_ptr(), b, l, h, p, g, n, L, *x.stride()[:3],
        *dt.stride(), *B.stride()[:3], *C.stride()[:3], _a_stride(A),
        None if entering is None else entering.data_ptr(), flags.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on_launch_error(rc, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, state, entering


# -- the backward ------------------------------------------------------------

def _bwd_call(kernel: str, code: int, tensors: dict, sizes: tuple,
              strides: dict) -> None:
    """One C entry of ``csrc/ssd_scan_bwd.cu``: ``tensors`` by name (the
    others null), ``sizes`` (b, l, h, p, g, n, L, a_rows), ``strides`` of
    x, dt, B, C (three each, dt's all three) and A's batch stride (0 where
    not given)."""
    device = next(iter(tensors.values())).device
    args = [code] + [tensors[k].data_ptr() if k in tensors else None
                     for k in BWD_TENSORS] + list(sizes)
    for k in ("x", "dt", "B", "C"):
        args += list(strides.get(k, (0, 0, 0)))
    args.append(strides.get("A", 0))
    args.append(torch.cuda.current_stream(device).cuda_stream)
    rc = getattr(_bwd_kernels(), kernel)(*args)
    _build.raise_on_launch_error(rc, kernel)
    launches[kernel] += 1


def _sizes(x_shape, B_shape, L: int, a_rows: int) -> tuple:
    b, l, h, p = x_shape
    return (b, l, h, p, B_shape[2], B_shape[3], L, a_rows)


def _launch_dstate(dt, A, C, dy, L: int, h: int):
    """Kernel 1 (``ref.bwd_dstate``): ``(ΔG (b, c, h, p, n), decay
    (b, c, h))``; chunk 0's ΔG, which feeds no chunk, is left unwritten."""
    b, l, _, p = dy.shape
    n = C.shape[3]
    dG = torch.empty((b, l // L, h, p, n), dtype=torch.float32,
                     device=dy.device)
    decay = torch.empty((b, l // L, h), dtype=torch.float32, device=dy.device)
    _bwd_call("ssd_bwd_dstate", _build.DTYPE_CODES[C.dtype],
              {"dt": dt, "A": A, "C": C, "dy": dy, "gs": dG, "decay": decay},
              _sizes((b, l, h, p), C.shape, L, 1),
              {"dt": dt.stride(), "C": C.stride()[:3], "A": _a_stride(A)})
    return dG, decay


def _launch_chain(dG, decay, dS_last):
    """Kernel 2 (``ref.bwd_chain``): G, written over ΔG."""
    b, c, h, p, n = dG.shape
    _bwd_call("ssd_bwd_chain", 0,
              {"dS_last": dS_last, "gs": dG, "decay": decay},
              (b, c, h, p, 1, n, 1, 1), {})
    return dG


def _launch_chunk(x, dt, A, B, C, dy, states, final, G, L: int):
    """Kernel 3 (``ref.bwd_chunk``): ``(dx, ddt, dBh, dCh, dA_chunks)``."""
    b, l, h, p = x.shape
    n = B.shape[3]
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, l, h), **f32)
    dBh = torch.empty((b, l, h, n), **f32)
    dCh = torch.empty((b, l, h, n), **f32)
    dA_chunks = torch.empty((b, l // L, h), **f32)
    _bwd_call("ssd_bwd_chunk", _build.DTYPE_CODES[x.dtype],
              {"x": x, "dt": dt, "A": A, "B": B, "C": C, "dy": dy,
               "states": states, "final": final, "gs": G, "dx": dx,
               "ddt": ddt, "dBh": dBh, "dCh": dCh, "dA_chunks": dA_chunks},
              _sizes(x.shape, B.shape, L, 1),
              {"x": x.stride()[:3], "dt": dt.stride(), "B": B.stride()[:3],
               "C": C.stride()[:3], "A": _a_stride(A)})
    return dx, ddt, dBh, dCh, dA_chunks


def _launch_reduce(dBh, dCh, dA_chunks, g: int, dtype: torch.dtype,
                   shared_a: bool):
    """Kernel 4 (``ref.bwd_reduce``): ``(dB, dC, dA)``."""
    b, l, h, n = dBh.shape
    c = dA_chunks.shape[1]
    a_rows = 1 if shared_a else b
    dB = torch.empty((b, l, g, n), dtype=dtype, device=dBh.device)
    dC = torch.empty((b, l, g, n), dtype=dtype, device=dBh.device)
    dA = torch.empty((h,) if shared_a else (b, h), dtype=torch.float32,
                     device=dBh.device)
    _bwd_call("ssd_bwd_reduce", _build.DTYPE_CODES[dtype],
              {"dBh": dBh, "dCh": dCh, "dA_chunks": dA_chunks, "dB": dB,
               "dC": dC, "dA": dA},
              (b, l, h, 1, g, n, l // c, a_rows), {})
    return dB, dC, dA


def _check_bwd(x, B, dy, dS_last, states, state, L: int) -> None:
    b, l, h, p = x.shape
    n = B.shape[3]
    want = {"dy": (dy, (b, l, h, p)), "dS_last": (dS_last, (b, h, p, n))}
    if not _on_cpu(x):
        want.update(states=(states, (b, l // L, h, p, n)),
                    state=(state, (b, h, p, n)))
    for name, (t, shape) in want.items():
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != shape
                or t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{x.device}")


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 dy: torch.Tensor, dS_last: torch.Tensor,
                 states: Optional[torch.Tensor] = None,
                 state: Optional[torch.Tensor] = None) -> tuple:
    """The gradients ``(dx, ddt, dA, dB, dC)`` of ``ssd_scan`` for the
    float32 cotangents ``dy (b, l, h, p)`` and ``dS_last (b, h, p, n)``:
    dx, dB and dC in the dtypes of x, B and C, ddt and dA (A's shape)
    float32.  On the card it reads the forward's ``states`` (the states
    entering each chunk) and final ``state``, and launches the four
    kernels once each; a CPU tensor takes ``ref.ssd_chunked_bwd``."""
    L = _check(x, dt, A, B, C, chunk)
    _check_bwd(x, B, dy, dS_last, states, state, L)
    if _on_cpu(x):
        return ref.ssd_chunked_bwd(x, dt, A, B, C, chunk, dy, dS_last)
    _check_kernel_range(x, B, L)
    dy, dS_last = dy.contiguous(), dS_last.contiguous()
    h = x.shape[2]
    dG, decay = _launch_dstate(dt, A, C, dy, L, h)
    G = _launch_chain(dG, decay, dS_last)
    dx, ddt, dBh, dCh, dA_chunks = _launch_chunk(
        x, dt, A, B, C, dy, states.contiguous(), state.contiguous(), G, L)
    del dG, G
    dB, dC, dA = _launch_reduce(dBh, dCh, dA_chunks, B.shape[2], B.dtype,
                                A.dim() == 1)
    return dx, ddt, dA, dB, dC


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class SSDScanFn(torch.autograd.Function):
    """``(y, state)`` of ``ssd_scan`` with ``ssd_scan_bwd`` as its
    backward.  The forward keeps the states entering each chunk (on the
    card) when ``save`` is set, which ``ssd_scan_diff`` decides from
    autograd's state: an inference call writes nothing more.  Under
    ``torch.func.vmap`` the ``vmap`` rule moves each input's vmapped axis
    to the front and folds it into b — A's too, expanded to ``(n·b, h)``,
    one row per client row, whose gradient autograd sums back per client —
    and calls the Function on the physical tensors, so each kernel runs
    once for the whole vmapped batch."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk, save):
        return ssd_scan(x, dt, A, B, C, chunk, states=save)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, B, C, chunk, save = inputs
        _, state, entering = output
        ctx.save_for_backward(x, dt, A, B, C, state, entering)
        ctx.mark_non_differentiable(*(t for t in (entering,)
                                      if t is not None))
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dS_last, _dstates):
        x, dt, A, B, C, state, entering = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssd_scan_bwd(x, dt, A, B, C, ctx.chunk, dy,
                                           dS_last, entering, state)
        return dx, ddt, dA, dB, dC, None, None

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, chunk, save):
        n = info.batch_size

        def front(t, dim):
            return (t.expand((n,) + t.shape) if dim is None
                    else t.movedim(dim, 0))

        def fold(t, dim):
            t = front(t, dim)
            return t.reshape((n * t.shape[1],) + t.shape[2:])

        x_, dt_ = fold(x, in_dims[0]), fold(dt, in_dims[1])
        if in_dims[2] is None:
            A_ = A                  # one A for every row: batch stride 0
        else:
            b = x_.shape[0] // n
            A_ = front(A, in_dims[2])[:, None].expand(
                n, b, A.shape[-1]).reshape(n * b, A.shape[-1])
        tensors = (x_, dt_, A_, fold(B, in_dims[3]), fold(C, in_dims[4]))
        y, state, entering = SSDScanFn.apply(
            *tensors, chunk, save or _needs_grad(*tensors))
        outs = (y.reshape((n, -1) + y.shape[1:]),
                state.reshape((n, -1) + state.shape[1:]),
                None if entering is None
                else entering.reshape((n, -1) + entering.shape[1:]))
        return outs, (0, 0, None if entering is None else 0)


def ssd_scan_diff(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(y, state)``: the forward kernel, and the four
    backward kernels in autograd's backward."""
    y, state, _ = SSDScanFn.apply(x, dt, A, B, C, chunk,
                                  _needs_grad(x, dt, A, B, C))
    return y, state
