"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) on the CPU: its
plain version against the JAX package's ``ssd_chunked`` (the model layer's
form, which ``repro.kernels.ssd_scan.ref`` re-exports) and against the
Pallas kernel ``ssd_scan`` in interpret mode, against its own literal
recurrence (``naive_ssd``, as tests/test_ssm_equivalence.py holds the
reference), and the wrapper's contract.

Inputs are made with numpy and handed to both packages.  TOL = 2e-4 rtol
and atol is the reference's own (tests/test_ssd_kernel.py): the chunked
form sums the same float32 terms in other orders in XLA and PyTorch."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.ops import (  # noqa: E402
    ssd_scan as pallas_ssd_scan)
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402
from _ssd_fake_card import plain_card  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-4
CASES = [
    # b, l, h, p, g, n, chunk
    (2, 64, 4, 16, 2, 8, 16),      # grouped B/C (zamba2-style), 4 chunks
    (1, 128, 2, 32, 1, 16, 32),    # single group, 4 chunks
    (2, 256, 4, 64, 4, 64, 128),   # P = N = 64, L = 128: 2 chunks
    (1, 64, 2, 16, 2, 8, 64),      # single chunk (no inter-chunk term)
    (2, 12, 4, 8, 2, 4, 16),       # ragged single chunk: l = 12 < chunk
    (1, 32, 2, 8, 1, 4, 16),       # 2 chunks
    (1, 100, 4, 16, 1, 8, 128),    # one ragged chunk of 100, as a prompt
]


def _inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrays, dtype=torch.float32):
    """numpy → torch; x, B and C in ``dtype``, dt and A float32."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def _jax(tensors):
    """The same values for the JAX package (bfloat16 stays bfloat16)."""
    out = []
    for t in tensors:
        if t.dtype == torch.bfloat16:
            out.append(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_reference_and_pallas(b, l, h, p, g, n, chunk,
                                                    dtype):
    args = _torch(_inputs(b, l, h, p, g, n), dtype)
    y, s = ref.ssd_chunked(*args, chunk)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)
    jargs = _jax(args)
    y_r, s_r = jax_ssd_chunked(*jargs, chunk)
    _close(y, y_r)
    _close(s, s_r)
    y_k, s_k = pallas_ssd_scan(*jargs, chunk, interpret=True)
    _close(y, y_k)
    _close(s, s_k)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_equals_recurrence(chunk):
    """The chunked form is an exact refactoring of the per-step recurrence
    (tolerance 1e-4, tests/test_ssm_equivalence.py's)."""
    args = _torch(_inputs(2, 64, 4, 16, 2, 8, seed=1))
    y_c, s_c = ref.ssd_chunked(*args, chunk)
    y_n, s_n = ref.naive_ssd(*args)
    np.testing.assert_allclose(y_c.numpy(), y_n.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s_c.numpy(), s_n.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    args = _torch(_inputs(2, 64, 4, 16, 2, 8))
    before = dict(ops.launches)
    y, s, entering = ops.ssd_scan(*args, 16)
    y_r, s_r = ref.ssd_chunked(*args, 16)
    assert torch.equal(y, y_r) and torch.equal(s, s_r) and entering is None
    assert ops.launches == before           # CPU tensors launch nothing


def test_wrapper_reads_model_slices_in_place(monkeypatch):
    """x, B and C as the Mamba2 block hands them over — views of one
    (b, l, conv_ch) tensor — reach the launch with their strides, uncopied;
    the chunk contract is the reference's."""
    b, l, h, p, g, n = 2, 32, 4, 8, 2, 4
    d_in = h * p
    xbc = torch.randn(b, l, d_in + 2 * g * n)
    x = xbc[..., :d_in].reshape(b, l, h, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
    dt = torch.rand(b, l, h) + 0.1
    A = -torch.rand(h) - 0.1
    seen = {}

    def fake_launch(*args):
        seen["args"] = args
        return "launched"

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_launch", fake_launch)
    assert ops.ssd_scan(x, dt, A, B, C, 16) == "launched"
    lx, _, _, lB, lC, L, states = seen["args"]
    assert L == 16 and not states
    for got, want in ((lx, x), (lB, B), (lC, C)):
        assert got.data_ptr() == want.data_ptr()
        assert got.stride() == want.stride()
    assert x.stride()[:2] == (l * xbc.shape[-1], xbc.shape[-1])
    # l < chunk: one chunk of all l positions
    ops.ssd_scan(x, dt, A, B, C, 128)
    assert seen["args"][5] == l


def _fake_card(monkeypatch):
    """Route the wrapper to ``_launch`` with the C library and the stream
    replaced by recorders; returns the list of the C entry's arguments."""
    calls = []

    def ssd_scan_fwd(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_kernels", lambda: types.SimpleNamespace(
        ssd_scan_fwd=ssd_scan_fwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def test_misaligned_views_reach_the_kernel(monkeypatch):
    """The kernel reads x, dt, B and C element by element through their
    strides, so views that start off a 16-byte boundary (here 2 bytes
    past it, bfloat16) launch as they are, as on the CPU."""
    b, l, h, p, g, n = 1, 32, 4, 8, 1, 4
    d_in = h * p
    raw = torch.randn(b, l, 1 + d_in + 2 * g * n).bfloat16()
    xbc = raw[..., 1:]
    x = xbc[..., :d_in].reshape(b, l, h, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
    dt = (torch.rand(b, l, h + 1) + 0.1)[..., 1:]
    A = -torch.rand(h) - 0.1
    assert all(t.data_ptr() % 16 for t in (x, B, C, dt))
    calls = _fake_card(monkeypatch)
    before = ops.launches["ssd_scan"]
    y, state, _ = ops.ssd_scan(x, dt, A, B, C, 16)
    assert ops.launches["ssd_scan"] == before + 1
    (args,) = calls
    assert args[1:6] == tuple(t.data_ptr() for t in (x, dt, A, B, C))
    assert args[6:8] == (y.data_ptr(), state.data_ptr())
    assert args[8:15] == (b, l, h, p, g, n, 16)
    assert args[15:27] == (*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                           *C.stride()[:3])
    assert args[27:29] == (0, None)         # one A (h,); no states kept


@pytest.mark.parametrize("shape,chunk,match", [
    ((1, 256, 2, 8, 1, 4), 256, "L = 256"),       # a chunk of 256 positions
    ((1, 16, 2, 129, 1, 4), 16, "p = 129"),
    ((1, 16, 2, 8, 1, 129), 16, "n = 129"),
])
def test_kernel_limits_raise_on_the_card(monkeypatch, shape, chunk, match):
    """The kernel takes P, N and the chunk length L = min(chunk, l) up to
    128; beyond that a CUDA call raises before the launch."""
    args = _torch(_inputs(*shape))
    calls = _fake_card(monkeypatch)
    with pytest.raises(ValueError, match=match):
        ops.ssd_scan(*args, chunk)
    assert not calls


def test_cuda_autograd_launches_the_backward_kernels(monkeypatch):
    """On a CUDA tensor (the dispatch faked here) a call under autograd
    launches the forward once, keeping the states entering each chunk, and
    its backward each of the four kernels once, never the CPU route; the
    gradients equal the CPU route's to the bit (the fake kernels compute
    its stages).  Under inference the forward keeps no states."""
    arrays = _torch(_inputs(2, 64, 4, 16, 2, 8))
    leaves = [t.clone().requires_grad_() for t in arrays]
    plain_bwd = ref.ssd_chunked_bwd
    seen = plain_card(monkeypatch)
    y, s = ops.ssd_scan_diff(*leaves, 16)
    (y.square().sum() + s.sum()).backward()
    assert ops.launches == {name: 1 for name in ops.launches}
    assert [ln.shapes for ln in seen["ssd_bwd_chunk"]] == [(
        (2, 64, 4, 16), (2, 64, 4), (4,), (2, 64, 2, 8), (2, 64, 2, 8),
        (2, 64, 4, 16), (2, 4, 4, 16, 8), (2, 4, 16, 8), (2, 4, 4, 16, 8))]
    cpu = [t.clone().requires_grad_() for t in arrays]
    y_c, s_c = ops.SSDScanFn.forward(*cpu, 16, False)[:2]
    dy, dS = 2 * y_c.detach(), torch.ones_like(s_c)
    want = plain_bwd(*arrays, 16, dy, dS)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    ops.reset_launches()
    with torch.inference_mode():
        ops.ssd_scan_diff(*arrays, 16)
    assert seen["ssd_scan"][-1].shapes == tuple(tuple(t.shape)
                                                for t in arrays)
    assert ops.launches["ssd_scan"] == 1
    assert not any(ops.launches[name] for name in ops.BWD_KERNELS)


def _bwd_recorder(monkeypatch):
    calls = []

    def record(name):
        def entry(*args):
            calls.append((name, args))
            return 0
        return entry

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_bwd_kernels", lambda: types.SimpleNamespace(
        **{name: record(name) for name in ops.BWD_KERNELS}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


@pytest.mark.parametrize("a_rows", [False, True])
def test_backward_kernels_receive_slices_in_place(monkeypatch, a_rows):
    """x, B and C as the Mamba2 block hands them over (views of one conv
    output, bfloat16) reach the four C entries in order with their
    pointers and strides, uncopied, A with its batch stride (0 for one A
    (h,), h for (b, h)); each entry gets the common argument list, its
    scratch and outputs in the named slots, the others null."""
    b, l, h, p, g, n, L = 2, 32, 4, 8, 2, 4, 16
    d_in = h * p
    xbc = torch.randn(b, l, d_in + 2 * g * n).bfloat16()
    x = xbc[..., :d_in].reshape(b, l, h, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
    dt = torch.rand(b, l, h) + 0.1
    A = -torch.rand((b, h) if a_rows else (h,)) - 0.1
    dy = torch.randn(b, l, h, p)
    dS = torch.randn(b, h, p, n)
    states = torch.randn(b, l // L, h, p, n)
    state = torch.randn(b, h, p, n)
    calls = _bwd_recorder(monkeypatch)
    dx, ddt, dA, dB, dC = ops.ssd_scan_bwd(x, dt, A, B, C, L, dy, dS,
                                           states, state)
    assert [name for name, _ in calls] == list(ops.BWD_KERNELS)
    assert (dx.dtype, dB.dtype, dC.dtype) == (torch.bfloat16,) * 3
    assert dA.shape == A.shape and dB.shape == B.shape == dC.shape
    k = len(ops.BWD_TENSORS)
    slots = {name: dict(zip(ops.BWD_TENSORS, args[1:1 + k]))
             for name, args in calls}
    ptr = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "dy": dy,
           "dS_last": dS, "states": states, "final": state, "dx": dx,
           "ddt": ddt, "dB": dB, "dC": dC, "dA": dA}
    reads = {"ssd_bwd_dstate": ("dt", "A", "C", "dy"),
             "ssd_bwd_chain": ("dS_last",),
             "ssd_bwd_chunk": ("x", "dt", "A", "B", "C", "dy", "states",
                               "final", "dx", "ddt"),
             "ssd_bwd_reduce": ("dB", "dC", "dA")}
    for name, names in reads.items():
        for t in names:
            assert slots[name][t] == ptr[t].data_ptr(), (name, t)
    # ΔG is written by the first and chained over in place by the second
    assert slots["ssd_bwd_dstate"]["gs"] == slots["ssd_bwd_chain"]["gs"] \
        == slots["ssd_bwd_chunk"]["gs"] is not None
    assert slots["ssd_bwd_chunk"]["dB"] is None
    (_, chunk), = [c for c in calls if c[0] == "ssd_bwd_chunk"]
    assert chunk[0] == 1                             # bfloat16
    assert chunk[1 + k:9 + k] == (b, l, h, p, g, n, L, 1)
    assert chunk[9 + k:22 + k] == (*x.stride()[:3], *dt.stride(),
                                   *B.stride()[:3], *C.stride()[:3],
                                   h if a_rows else 0)
    assert x.stride()[:2] == (l * xbc.shape[-1], xbc.shape[-1])
    (_, reduce), = [c for c in calls if c[0] == "ssd_bwd_reduce"]
    assert reduce[1 + k:9 + k] == (b, l, h, 1, g, n, L, b if a_rows else 1)


def test_cpu_autograd_takes_the_differentiable_plain_version():
    args = list(_torch(_inputs(1, 16, 2, 8, 1, 4)))
    for t in args:
        t.requires_grad_(True)
    y, s, _ = ops.ssd_scan(*args, 8)
    (y.sum() + s.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in args)


@pytest.mark.parametrize("change,err,match", [
    (lambda a: a.update(chunk=12), ValueError, "multiple of the chunk"),
    (lambda a: a.update(chunk=0), ValueError, "positive int"),
    (lambda a: a.update(x=a["x"].half()), TypeError, "float32 or bfloat16"),
    (lambda a: a.update(B=a["B"].bfloat16()), TypeError, "share a dtype"),
    (lambda a: a.update(dt=a["dt"].double()), TypeError, "float32"),
    (lambda a: a.update(A=a["A"][:3]), ValueError, "A"),
    (lambda a: a.update(dt=a["dt"][:, :8]), ValueError, "dt must be"),
    (lambda a: a.update(C=a["C"][:, :, :1]), ValueError, "B and C"),
    (lambda a: a.update(x=a["x"][..., 0]), ValueError, "4-d"),
    (lambda a: a.update(x=a["x"].transpose(2, 3)), ValueError, "contiguous"),
    (lambda a: a.update(x=a["x"][:, :, :3], dt=a["dt"][..., :3],
                        A=a["A"][:3]), ValueError, "multiple of g"),
    (lambda a: a.update(x=a["x"].to("meta")), ValueError, "is on"),
])
def test_wrapper_contract_errors(change, err, match):
    x, dt, A, B, C = _torch(_inputs(1, 16, 4, 8, 2, 8))
    a = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "chunk": 8}
    change(a)
    with pytest.raises(err, match=match):
        ops.ssd_scan(a["x"], a["dt"], a["A"], a["B"], a["C"], a["chunk"])
