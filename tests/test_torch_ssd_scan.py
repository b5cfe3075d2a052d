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
    y, s = ops.ssd_scan(*args, 16)
    y_r, s_r = ref.ssd_chunked(*args, 16)
    assert torch.equal(y, y_r) and torch.equal(s, s_r)
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
    lx, _, _, lB, lC, L = seen["args"]
    assert L == 16
    for got, want in ((lx, x), (lB, B), (lC, C)):
        assert got.data_ptr() == want.data_ptr()
        assert got.stride() == want.stride()
    assert x.stride()[:2] == (l * xbc.shape[-1], xbc.shape[-1])
    # l < chunk: one chunk of all l positions
    ops.ssd_scan(x, dt, A, B, C, 128)
    assert seen["args"][-1] == l


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
    y, state = ops.ssd_scan(x, dt, A, B, C, 16)
    assert ops.launches["ssd_scan"] == before + 1
    (args,) = calls
    assert args[1:6] == tuple(t.data_ptr() for t in (x, dt, A, B, C))
    assert args[6:8] == (y.data_ptr(), state.data_ptr())
    assert args[8:15] == (b, l, h, p, g, n, 16)
    assert args[15:27] == (*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                           *C.stride()[:3])


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


def test_cuda_autograd_raises_instead_of_falling_back(monkeypatch):
    """No backward kernel yet: on a CUDA tensor (the dispatch mocked here)
    a call under autograd raises, naming the queued SSD backward; under
    inference it launches."""
    args = list(_torch(_inputs(1, 16, 2, 8, 1, 4)))
    launched = []
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_launch", lambda *a: launched.append(1))
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="SSD backward.*B9"):
        ops.ssd_scan(*args, 8)
    assert not launched
    with torch.inference_mode():
        ops.ssd_scan(*args, 8)
    with torch.no_grad():
        ops.ssd_scan(*args, 8)
    assert len(launched) == 2


def test_cpu_autograd_takes_the_differentiable_plain_version():
    args = list(_torch(_inputs(1, 16, 2, 8, 1, 4)))
    for t in args:
        t.requires_grad_(True)
    y, s = ops.ssd_scan(*args, 8)
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
