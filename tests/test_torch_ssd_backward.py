"""The SSD backward of the port (``repro_torch.kernels.ssd_scan``) on the
CPU: the plain chunked VJP ``ref.ssd_chunked_bwd`` — the four stages the
card's kernels compute — against ``jax.vjp`` of the reference's
``ssd_chunked`` (``src/repro/models/mamba2.py``, which the reference trains
through) and against ``torch.autograd`` of the plain forward; ``SSDScanFn``
under ``torch.func.vmap`` with one A per client against a per-client loop;
and the dtypes of the gradients.

Inputs are made with numpy from a seed.  Tolerances are fractions of each
gradient's largest entry.  dx, ddt, dB and dC: GRAD_TOL = 1e-5; the same
float32 terms are summed in other orders by XLA's autodiff and by the
explicit VJP (measured ≤ 2.8e-6).  dA: DA_TOL = 2e-4; dA sums ddA·dt over a
head's positions, ddA being the reverse cumsum of C·dC − xdt·d(xdt), two
large terms that cancel, so its float32 rounding is larger (measured
≤ 1.7e-5 here; the plain version itself is 3e-4 from a float64 reference at
P = N = 128)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

GRAD_TOL = 1e-5
DA_TOL = 2e-4
CASES = [
    # b, l, h, p, g, n, chunk
    (1, 64, 2, 16, 2, 8, 64),      # one chunk, grouped
    (2, 64, 4, 16, 2, 8, 16),      # 4 chunks, grouped
    (1, 32, 2, 8, 1, 4, 16),       # 2 chunks, one group
    (1, 96, 4, 16, 1, 8, 32),      # 3 chunks, one group
    (2, 12, 4, 8, 2, 4, 16),       # l < chunk: one chunk of 12
]
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(b, l, h, p, g, n, seed=0, a_rows=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal((b, h) if a_rows else h))
         ).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dS = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, A, B, C), dy, dS


def _assert_grads(got, want):
    for name, a, w in zip(NAMES, got, want):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        w = np.asarray(w, np.float32)
        assert a.shape == w.shape, name
        tol = (DA_TOL if name == "dA" else GRAD_TOL) * np.abs(w).max()
        np.testing.assert_allclose(a, w, rtol=0, atol=tol, err_msg=name)


@functools.cache
def _jax_vjp(chunk):
    """The reference's VJP of ``ssd_chunked``, jitted: one compile per
    shape instead of one per operation."""
    def vjp(arrays, dy, dS):
        return jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk),
                       *arrays)[1]((dy, dS))
    return jax.jit(vjp)


@pytest.mark.parametrize("dS_zero", [False, True])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", CASES)
def test_plain_backward_matches_jax_vjp(b, l, h, p, g, n, chunk, dS_zero):
    arrays, dy, dS = _inputs(b, l, h, p, g, n)
    if dS_zero:
        dS = np.zeros_like(dS)
    want = _jax_vjp(chunk)(tuple(jnp.asarray(a) for a in arrays),
                           jnp.asarray(dy), jnp.asarray(dS))
    got = ref.ssd_chunked_bwd(*(torch.from_numpy(a) for a in arrays), chunk,
                              torch.from_numpy(dy), torch.from_numpy(dS))
    _assert_grads(got, want)


@pytest.mark.parametrize("a_rows", [False, True])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", CASES[1:3])
def test_plain_backward_matches_torch_autograd(b, l, h, p, g, n, chunk,
                                               a_rows):
    """Against autograd of ``ref.ssd_chunked``, also with A ``(b, h)``, one
    row per batch row (the vmapped clients' fold)."""
    arrays, dy, dS = _inputs(b, l, h, p, g, n, seed=1, a_rows=a_rows)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, S = ref.ssd_chunked(*leaves, chunk)
    want = torch.autograd.grad(
        (y * torch.from_numpy(dy)).sum() + (S * torch.from_numpy(dS)).sum(),
        leaves)
    got = ref.ssd_chunked_bwd(*(torch.from_numpy(a) for a in arrays), chunk,
                              torch.from_numpy(dy), torch.from_numpy(dS))
    _assert_grads(got, [w.numpy() for w in want])


def test_vmap_with_per_client_A_equals_per_client_loop(monkeypatch):
    """``SSDScanFn`` under ``torch.func.vmap`` over three clients, each with
    its own A and x, B, C sliced from one conv output: one forward call
    covers them (A folded to (3·b, h)), keeping the states entering each
    chunk for the backward, and the gradients equal those of a
    loop over the clients."""
    m, b, l, h, p, g, n, chunk = 3, 2, 32, 4, 8, 2, 4, 16
    rng = np.random.default_rng(2)
    d_in = h * p
    xbc = torch.from_numpy(rng.standard_normal(
        (m, b, l, d_in + 2 * g * n)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (m, b, l, h)))).astype(np.float32))
    a_log = torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(np.float32))

    def loss(xbc, dt, a_log):
        x = xbc[..., :d_in].reshape(b, l, h, p)
        B = xbc[..., d_in:d_in + g * n].reshape(b, l, g, n)
        C = xbc[..., d_in + g * n:].reshape(b, l, g, n)
        y, S = ops.ssd_scan_diff(x, dt, -torch.exp(a_log), B, C, chunk)
        return (y * w).sum() + S.square().sum()

    calls = []
    plain = ops.ssd_scan

    def counted(*args, **kw):
        calls.append((tuple(args[0].shape), tuple(args[2].shape),
                      kw.get("states", False)))
        return plain(*args, **kw)

    leaves = [t.clone().requires_grad_() for t in (xbc, dt, a_log)]
    monkeypatch.setattr(ops, "ssd_scan", counted)
    losses = torch.func.vmap(loss)(*leaves)
    got = torch.autograd.grad(losses.sum(), leaves)
    assert calls == [((m * b, l, h, p), (m * b, h), True)]
    monkeypatch.setattr(ops, "ssd_scan", plain)
    loop = [t.clone().requires_grad_() for t in (xbc, dt, a_log)]
    total = sum(loss(*(t[i] for t in loop)) for i in range(m))
    want = torch.autograd.grad(total, loop)
    np.testing.assert_allclose(losses.detach().numpy(),
                               [float(loss(*(t[i] for t in (xbc, dt, a_log))))
                                for i in range(m)], rtol=1e-6)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0,
                                   atol=1e-6 * float(b_.abs().max()))


def test_bfloat16_inputs_get_bfloat16_gradients():
    """x, B and C in bfloat16: dx, dB and dC come back bfloat16 (float32
    sums rounded once), ddt and dA float32; through ``SSDScanFn`` the
    leaves' gradients keep their dtypes."""
    arrays, dy, dS = _inputs(2, 32, 4, 8, 2, 4)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    got = ops.ssd_scan_bwd(x, dt, A, B, C, 16, torch.from_numpy(dy),
                           torch.from_numpy(dS))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    want = ref.ssd_chunked_bwd(x.float(), dt, A, B.float(), C.float(), 16,
                               torch.from_numpy(dy), torch.from_numpy(dS))
    for name, a, w in zip(NAMES, got, want):
        assert torch.equal(a, w.to(a.dtype)), name
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, S = ops.ssd_scan_diff(*leaves, 16)
    (y.sum() + S.sum()).backward()
    assert [t.grad.dtype for t in leaves] == [t.dtype for t in leaves]
