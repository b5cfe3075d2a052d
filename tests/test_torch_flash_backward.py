"""The port's flash-attention backward (on CPU tensors: its plain PyTorch
version, ``ref.attention_bwd``, reached directly and through
``FlashAttentionFn`` and its vmap rule) against the JAX reference's
gradients: ``jax.vjp`` of ``flash_attention_diff(..., interpret=True)``,
whose backward is the Pallas ``flash_attention_bwd_bhsd`` (``_dq_kernel``
and ``_dkv_kernel``) in interpret mode.  The reference pads head dim 64 to
128 and rescales q; the port takes the head dim as it is.  Its kernel asks
``S % min(256, S) == 0`` (ROADMAP C7), hence S ∈ {16, 64, 128, 256}.

Tolerance: float32 summation-order noise.  Against a float64 autograd
reference the plain version is within 1e-6 of each gradient's largest
entry at these sizes; the two packages are held to GRAD_TOL of it
(absolute) plus GRAD_TOL relative.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

GRAD_TOL = 1e-5
CASES = [
    # B, S, H, Hkv, D, window
    (2, 16, 4, 4, 64, 0),         # MHA, the shortest length
    (1, 64, 8, 2, 64, 0),         # GQA g = 4
    (1, 128, 8, 1, 128, 0),       # MQA g = 8, head dim 128 (no padding)
    (1, 128, 4, 4, 64, 32),       # MHA + window
    (1, 256, 8, 2, 64, 32),       # GQA + window, two-tile length
    (2, 64, 8, 1, 64, 32),        # MQA + window
    (1, 256, 4, 1, 128, 0),       # MQA, head dim 128, S 256
]


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, H, D))]


def _jax_grads(q, k, v, do, window):
    fn = lambda q_, k_, v_: jops.flash_attention_diff(  # noqa: E731
        q_, k_, v_, causal=True, window=window, interpret=True)
    o, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(want).max())


@pytest.mark.parametrize("B,S,H,Hkv,D,window", CASES)
def test_backward_matches_pallas_backward(B, S, H, Hkv, D, window):
    q, k, v, do = _inputs(B, S, H, Hkv, D, seed=S + D + H + window)
    jo, jgrads = _jax_grads(q, k, v, do, window)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    before = dict(ops.launches)
    # the plain version, from the forward's o and lse
    o, lse = ops.flash_attention_fwd(tq, tk, tv, window=window)
    for got, want in zip(ops.flash_attention_bwd(tq, tk, tv, o, lse, tdo,
                                                 window=window), jgrads):
        _close(got, want)
    # the per-kernel wrappers: dq, and dk / dv
    delta = ref.row_delta(tdo, o)
    _close(ops.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta,
                                      window=window), jgrads[0])
    for got, want in zip(ops.flash_attention_bwd_dkv(
            tq, tk, tv, tdo, lse, delta, window=window), jgrads[1:]):
        _close(got, want)
    # autograd through FlashAttentionFn
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention_diff(*leaves, window=window)
    _close(out, jo)
    for got, want in zip(torch.autograd.grad(out, leaves, tdo), jgrads):
        _close(got, want)
    assert ops.launches == before          # CPU tensors launch nothing


@pytest.mark.parametrize("k_batched", [True, False])
def test_vmap_rule_equals_per_client_loop(k_batched):
    """``torch.func.vmap`` over a client axis (k and v shared when
    ``k_batched`` is False), gradients taken outside the vmap: the
    backward runs once for all clients and equals a per-client loop."""
    rng = np.random.default_rng(11)
    M, B, S, H, Hkv, D = 3, 2, 24, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((M, B, S, H, D), np.float32))
    kv_shape = ((M,) if k_batched else ()) + (B, S, Hkv, D)
    k = torch.from_numpy(rng.standard_normal(kv_shape, np.float32))
    v = torch.from_numpy(rng.standard_normal(kv_shape, np.float32))
    w = torch.from_numpy(rng.standard_normal((M, B, S, H, D), np.float32))

    def loss(q_, k_, v_, w_):
        return (ops.flash_attention_diff(q_, k_, v_, window=8) * w_).sum()

    calls = []
    real = ops.flash_attention_bwd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    in_dims = (0, 0 if k_batched else None, 0 if k_batched else None, 0)
    ops.flash_attention_bwd = counted
    try:
        losses = torch.func.vmap(loss, in_dims=in_dims)(*leaves, w)
        grads = torch.autograd.grad(losses.sum(), leaves)
    finally:
        ops.flash_attention_bwd = real
    assert calls == [(M * B, S, H, D)]      # one backward, clients folded
    for i in range(M):
        qi = q[i].clone().requires_grad_()
        ki, vi = ((k[i], v[i]) if k_batched else (k, v))
        ki, vi = ki.clone().requires_grad_(), vi.clone().requires_grad_()
        li = loss(qi, ki, vi, w[i])
        torch.testing.assert_close(losses[i], li, rtol=1e-6, atol=1e-6)
        gi = torch.autograd.grad(li, (qi, ki, vi))
        torch.testing.assert_close(grads[0][i], gi[0], rtol=1e-6, atol=1e-6)
        if k_batched:
            for g, want in zip(grads[1:], gi[1:]):
                torch.testing.assert_close(g[i], want, rtol=1e-6, atol=1e-6)
    if not k_batched:
        # shared k / v: their gradient is the sum over the clients
        kk, vv = k.clone().requires_grad_(), v.clone().requires_grad_()
        total = sum(loss(q[i], kk, vv, w[i]) for i in range(M))
        for g, want in zip(grads[1:], torch.autograd.grad(total, (kk, vv))):
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


def test_row_without_keys_has_zero_gradient():
    """Late rows under a window with Skv < Sq see no key: o = 0 and every
    gradient through them is exactly 0 (so is dq of a row that sees one
    key, where p = 1 and ds = dp − δ = 0; row 1 sees two)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 8, 1, 4), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1, 4), np.float32))
            for _ in range(2))
    o, lse = ops.flash_attention_fwd(q, k, v, window=2)
    do = torch.ones_like(o)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do, window=2)
    assert torch.all(dq[:, 2:] == 0) and torch.all(dq[:, 1] != 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_serving_under_inference_mode_records_no_graph():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 5, 2, 8), np.float32))
               for _ in range(3))
    with torch.inference_mode():
        o = ops.flash_attention_diff(q, k, v)
    assert o.grad_fn is None
    torch.testing.assert_close(o, ops.flash_attention(q, k, v))


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("do,lse,match", [
    (_t(1, 4, 2, 6), _t(1, 2, 4), "do must be"),
    (_t(1, 4, 2, 8, dtype=torch.bfloat16), _t(1, 2, 4), "do must be"),
    (_t(1, 4, 2, 8), _t(1, 4, 2), "lse must be"),
    (_t(1, 4, 2, 8), _t(1, 2, 4, dtype=torch.bfloat16), "lse must be"),
])
def test_backward_rejects_bad_operands(do, lse, match):
    q = _t(1, 4, 2, 8)
    before = dict(ops.launches)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.flash_attention_bwd(q, q, q, _t(1, 4, 2, 8), lse, do)
    with pytest.raises((ValueError, TypeError), match=match):
        ops.flash_attention_bwd_dq(q, q, q, do, lse, _t(1, 2, 4))
    assert ops.launches == before
