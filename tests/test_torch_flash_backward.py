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

The tests at the end route the wrappers to a recorder in place of the CUDA
library (a fake card): what reaches the C interface — copy width, tensors,
shapes, strides, the GQA group's workspace — is checked here, the kernels
themselves only on the card (chip_smoke.py phase 7).
"""
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

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


H100_SMS = 132                        # an H100 SXM's SMs


def _fake_card(monkeypatch):
    """Route both backward wrappers to the launch with the C library, the
    stream and the card's SM count replaced by recorders and an H100's;
    returns each C entry's list of argument tuples."""
    calls = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}

    def recorder(name):
        def entry(*args):
            calls[name].append(args)
            return 0
        return entry

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(ops, "_bwd_kernels", lambda: types.SimpleNamespace(
        **{name: recorder(name) for name in calls}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def _fused(B, S, H, Hkv, D, lead, dtype=torch.bfloat16):
    """q, k, v as views of one fused QKV buffer with ``lead`` elements
    before q in each row."""
    buf = torch.zeros(B, S, lead + (H + 2 * Hkv) * D, dtype=dtype)
    cuts = [lead, lead + H * D, lead + (H + Hkv) * D, lead + (H + 2 * Hkv) * D]
    return [buf[..., a:b].unflatten(-1, (h, D))
            for a, b, h in zip(cuts, cuts[1:], (H, Hkv, Hkv))]


def _rows(q):
    """lse and δ stand-ins, float32 (B, H, Sq)."""
    B, Sq, H, _ = q.shape
    return _t(B, H, Sq), _t(B, H, Sq)


def _offset(shape, lead, dtype=torch.bfloat16):
    """A contiguous tensor whose base lies ``lead`` elements past an
    allocation's start."""
    return torch.zeros(math.prod(shape) + lead, dtype=dtype)[lead:].reshape(
        shape)


@pytest.mark.parametrize("make,width", [
    # (q, k, v, do) -> the widest copy that divides every row start
    (lambda: [_t(1, 8, 4, 128, dtype=torch.bfloat16)] * 4, 16),
    (lambda: [_t(2, 8, 4, 36, dtype=torch.bfloat16)] * 4, 8),   # 72-B heads
    (lambda: [_t(2, 8, 4, 98, dtype=torch.bfloat16)] * 4, 4),   # 196-B heads
    (lambda: [_t(2, 8, 4, 77, dtype=torch.bfloat16)] * 4, 2),   # 154-B heads
    (lambda: [_t(2, 8, 4, 77)] * 4, 4),                         # float32
    (lambda: _fused(1, 8, 4, 2, 128, 0) + [_t(1, 8, 4, 128,
                                                dtype=torch.bfloat16)], 16),
    (lambda: _fused(1, 8, 4, 2, 128, 1) + [_t(1, 8, 4, 128,
                                                dtype=torch.bfloat16)], 2),
    (lambda: _fused(1, 8, 4, 2, 128, 4) + [_t(1, 8, 4, 128,
                                                dtype=torch.bfloat16)], 8),
    # the cotangent alone off a 16-byte boundary
    (lambda: [_t(1, 8, 4, 64, dtype=torch.bfloat16)] * 3
     + [_offset((1, 8, 4, 64), 2)], 4),
    (lambda: [_t(1, 8, 4, 64, dtype=torch.bfloat16)] * 3
     + [_offset((1, 8, 4, 64), 1)], 2),
])
def test_backward_wrappers_pass_the_copy_width(monkeypatch, make, width):
    """Both backward wrappers hand the C entry the widest copy width that
    divides every row start of q, k, v and do (``ops.copy_width``)."""
    q, k, v, do = make()
    lse, delta = _rows(q)
    calls = _fake_card(monkeypatch)
    ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert ops.copy_width(q, k, v, do) == width
    for name in calls:
        (args,) = calls[name]
        assert args[1] == width
        assert args[2:6] == tuple(t.data_ptr() for t in (q, k, v, do))


BWD_ACCEPTED = [
    # (B, Sq, Skv, H, Hkv, Dqk, Dv, window): every shape the wrappers take
    # reaches the launch — MHA, GQA, MQA, ragged lengths, Sq ≠ Skv both
    # ways, windows, head dims of 1, not multiples of 16, up to 256, and
    # Dv ≠ Dqk
    (4, 128, 128, 8, 1, 256, 256, 0),
    (1, 256, 256, 32, 8, 128, 128, 0),
    (4, 128, 128, 32, 32, 80, 80, 0),
    (2, 77, 77, 4, 2, 36, 36, 0),
    (1, 64, 64, 4, 2, 77, 77, 0),
    (1, 160, 96, 4, 1, 64, 64, 48),
    (1, 96, 160, 4, 2, 64, 64, 0),
    (1, 512, 512, 4, 2, 64, 64, 128),
    (1, 40, 40, 4, 2, 48, 32, 0),
    (1, 50, 50, 2, 2, 64, 256, 0),
    (1, 5, 5, 2, 1, 1, 1, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dqk,Dv,window", BWD_ACCEPTED)
def test_backward_shapes_reach_the_kernels(monkeypatch, B, Sq, Skv, H, Hkv,
                                           Dqk, Dv, window, dtype):
    """On a CUDA tensor (the dispatch mocked here) each backward wrapper
    launches once with the arguments its C interface documents: dtype
    code, copy width, the tensors in place, the outputs, the workspace,
    the shape, the strides of q, k, v and do, the mask and the scale."""
    q, k = _t(B, Sq, H, Dqk, dtype=dtype), _t(B, Skv, Hkv, Dqk, dtype=dtype)
    v, do = _t(B, Skv, Hkv, Dv, dtype=dtype), _t(B, Sq, H, Dv, dtype=dtype)
    lse, delta = _rows(q)
    calls = _fake_card(monkeypatch)
    before = dict(ops.launches)
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, window=window,
                                    scale=0.125)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         window=window, scale=0.125)
    assert ops.launches["flash_attention_bwd_dq"] == (
        before["flash_attention_bwd_dq"] + 1)
    assert ops.launches["flash_attention_bwd_dkv"] == (
        before["flash_attention_bwd_dkv"] + 1)
    for t, like in ((dq, q), (dk, k), (dv, v)):
        assert t.shape == like.shape and t.dtype == dtype
    (a_dq,), (a_dkv,) = (calls["flash_attention_bwd_dq"],
                         calls["flash_attention_bwd_dkv"])
    for args in (a_dq, a_dkv):
        assert args[0] == (0 if dtype == torch.float32 else 1)
        assert args[1] == ops.copy_width(q, k, v, do)
        assert args[2:8] == tuple(t.data_ptr()
                                  for t in (q, k, v, do, lse, delta))
        assert args[11:18] == (B, H, Hkv, Sq, Skv, Dqk, Dv)
        assert args[18:30] == (*q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], *do.stride()[:3])
        assert args[30:] == (1, window, 0.125, 0)
    assert a_dq[8:11] == (dq.data_ptr(), None, None)
    assert a_dkv[8:10] == (dk.data_ptr(), dv.data_ptr())
    assert (a_dkv[10] is not None) == ops.dkv_split(q, k)


@pytest.mark.parametrize("B,Skv,H,Hkv,dtype,split", [
    # both dtypes: split when one block per (64-key tile, kv head, batch)
    # would give fewer blocks than the card's 132 SMs
    (4, 128, 8, 1, torch.bfloat16, True),      # gemma-2b's step: 8 blocks
    (1, 256, 32, 8, torch.bfloat16, True),     # 32 blocks
    (2, 4224, 4, 1, torch.bfloat16, False),    # 132 blocks: loop
    (2, 4160, 4, 1, torch.bfloat16, True),     # 130 blocks
    (1, 4096, 32, 8, torch.bfloat16, False),   # 512 blocks
    (1, 65, 4, 4, torch.bfloat16, False),      # MHA: no group to sum
    (1, 4096, 32, 8, torch.float32, False),    # 512 blocks
    (4, 128, 8, 1, torch.float32, True),       # gemma-2b's step: 8 blocks
    (1, 128, 4, 4, torch.float32, False),      # MHA: no group to sum
    (1, 256, 32, 8, torch.float32, True),      # 32 blocks
    (2, 4224, 4, 1, torch.float32, False),     # 132 blocks: loop
    (2, 4160, 4, 1, torch.float32, True),      # 130 blocks
])
def test_dkv_group_split_and_workspace(monkeypatch, B, Skv, H, Hkv, dtype,
                                       split):
    """The dk/dv wrapper's group handling follows ``dkv_split``'s
    documented rule, and the workspace it passes exactly when it splits
    holds B·H·Skv·(Dqk + Dv) float32 partials."""
    Dqk, Dv = 8, 4
    q, k = _t(B, 4, H, Dqk, dtype=dtype), _t(B, Skv, Hkv, Dqk, dtype=dtype)
    v, do = _t(B, Skv, Hkv, Dv, dtype=dtype), _t(B, 4, H, Dv, dtype=dtype)
    calls = _fake_card(monkeypatch)
    assert ops.dkv_split(q, k) == split
    ws = ops.dkv_workspace(q, k, v)
    if split:
        assert ws.dtype == torch.float32 and ws.device == q.device
        assert ws.numel() == B * H * Skv * (Dqk + Dv)
    else:
        assert ws is None
    lse, delta = _rows(q)
    ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    ops.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    assert (calls["flash_attention_bwd_dkv"][0][10] is not None) == split
    assert calls["flash_attention_bwd_dq"][0][10] is None


def _split_at_sm_count(sms, dtype):
    """``dkv_split`` at 116 blocks (B 2, Skv 3712, Hkv 1) on a card of
    ``sms`` SMs, twice, with the SM counts asked for."""
    q, k = _t(2, 4, 4, 8, dtype=dtype), _t(2, 3712, 1, 8, dtype=dtype)
    seen = []

    def properties(index):
        seen.append(index)
        return types.SimpleNamespace(multi_processor_count=sms)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "get_device_properties", properties)
        ops._sm_count.cache_clear()
        try:
            got = [ops.dkv_split(q, k), ops.dkv_split(q, k)]
        finally:
            ops._sm_count.cache_clear()
    return got, seen, q.device.index


@pytest.mark.parametrize("sms,split", [(132, True), (114, False)],
                         ids=["h100_sxm", "h100_pcie"])
def test_dkv_split_reads_the_cards_sm_count_in_float32(sms, split):
    """The float32 rule is bfloat16's: 116 blocks split on an H100 SXM's
    132 SMs and loop on an H100 PCIe's 114, the count read once."""
    got, seen, index = _split_at_sm_count(sms, torch.float32)
    assert got == [split, split]
    assert seen == [index]


@pytest.mark.parametrize("sms,split", [(132, True), (114, False)],
                         ids=["h100_sxm", "h100_pcie"])
def test_dkv_split_reads_the_cards_sm_count(sms, split):
    """The bfloat16 rule compares its block count with the SMs the card
    reports: 116 blocks (B 2, Skv 3712, Hkv 1) are fewer than an H100
    SXM's 132 SMs but more than an H100 PCIe's 114."""
    got, seen, index = _split_at_sm_count(sms, torch.bfloat16)
    assert got == [split, split]
    assert seen == [index]                    # read once, then cached
