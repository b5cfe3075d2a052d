"""The port's flash-attention forward (on CPU tensors: its plain PyTorch
version) against the JAX Pallas kernel ``flash_attention_fwd_bhsd`` in
interpret mode, and the model-layout wrappers against each other.

The JAX side takes the ``(B, H, S, D)`` layout its kernel reads; the port
reads the model layout ``(B, S, H, D)`` itself.  Tolerances: float32 1e-5
(the two sum the same float32 terms in another order); bfloat16 one bf16
ulp of ``o`` (the same float32 value, within summation order, rounded once
to bfloat16 can land one ulp apart) and 1e-5 for the float32 ``lse``."""
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_fwd_bhsd)
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

CASES = [
    # B, S, H, Hkv, D, window (the cases of tests/test_kernels.py)
    (2, 128, 4, 4, 64, 0),        # MHA
    (1, 256, 8, 2, 64, 0),        # GQA 4:1
    (2, 128, 4, 1, 128, 0),       # MQA
    (1, 256, 4, 4, 64, 64),       # sliding window
    (1, 128, 2, 2, 80, 0),        # head dim 80
    (1, 512, 2, 1, 64, 128),      # GQA + window
]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7                  # bf16 spacing relative to |x|


def _qkv(B, S, H, Hkv, D, seed, dtype="float32", Dv=None):
    """numpy q/k/v (model layout) in ``dtype`` (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv or D)]
    return [np.array(jnp.asarray(rng.standard_normal(s, np.float32))
                     .astype(DTYPES[dtype])) for s in shapes]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_o(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        tol = BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-6
        assert np.all(np.abs(got - want) <= tol), \
            float(np.max(np.abs(got - want) - tol))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,Hkv,D,window", CASES)
def test_plain_matches_pallas_kernel(B, S, H, Hkv, D, window, dtype):
    q, k, v = _qkv(B, S, H, Hkv, D, seed=S + D + window, dtype=dtype)
    bhsd = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)]
    jo, jlse = flash_attention_fwd_bhsd(*bhsd, causal=True, window=window,
                                        block_q=64, block_k=64,
                                        interpret=True)
    before = dict(ops.launches)
    o, lse = ops.flash_attention_fwd(
        *(tensor_from_numpy(a, "cpu") for a in (q, k, v)),
        causal=True, window=window)
    assert ops.launches == before          # a CPU call launches nothing
    assert o.shape == (B, S, H, D) and o.dtype == getattr(torch, dtype)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _assert_o(o, np.asarray(jnp.asarray(jo).transpose(0, 2, 1, 3)
                            .astype(jnp.float32)), dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (1, 128, 4, 2, 64, 32), (1, 128, 2, 2, 80, 0), (1, 100, 4, 1, 32, 0)])
def test_model_layout_wrapper_matches_reference_ops(B, S, H, Hkv, D, window):
    """``ops.flash_attention`` against the reference's wrapper (which pads
    the head dim to 128 and rescales q) and, at a ragged length that the
    TPU kernel's tiling refuses, against the reference's jnp oracle."""
    q, k, v = _qkv(B, S, H, Hkv, D, seed=7)
    if S % 64:
        want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    window=window, use_pallas=False)
    else:
        want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    window=window, block_q=64, block_k=64,
                                    interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_value_head_dim_may_differ():
    """Dv ≠ Dqk (MLA's shape) with an explicit scale, against the plain
    formula written out."""
    q, k, v = _qkv(1, 40, 4, 2, 48, seed=3, Dv=32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ops.flash_attention_fwd(tq, tk, tv, scale=0.1)
    assert o.shape == (1, 40, 4, 32)
    kr = tk.repeat_interleave(2, dim=2)
    vr = tv.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", tq * 0.1, kr)
    s = s.masked_fill(~ref.visible(40, 40, True, 0), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_row_without_keys_is_zero():
    """A window over a kv length shorter than the queries leaves late rows
    with no visible key: o = 0 there, as the kernel's empty sums give."""
    q, _, _ = _qkv(1, 8, 1, 1, 4, seed=1)
    _, k, v = _qkv(1, 2, 1, 1, 4, seed=2)
    o, _ = ops.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True, window=2)
    assert torch.all(o[:, 3:] == 0) and torch.all(o[:, :3] != 0)


def _t(*shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("args,exc,match", [
    ((_t(1, 4, 2, 8, dtype=torch.float16),) * 3, TypeError, "float32"),
    ((_t(1, 4, 2, 8), _t(1, 4, 2, 8, dtype=torch.bfloat16), _t(1, 4, 2, 8)),
     TypeError, "share a dtype"),
    ((_t(4, 2, 8), _t(4, 2, 8), _t(4, 2, 8)), ValueError, "4-d"),
    ((_t(1, 4, 3, 8), _t(1, 4, 2, 8), _t(1, 4, 2, 8)), ValueError,
     "multiple of Hkv"),
    ((_t(1, 4, 2, 8), _t(1, 4, 2, 6), _t(1, 4, 2, 8)), ValueError,
     "head dims differ"),
    ((_t(1, 4, 2, 300), _t(1, 4, 2, 300), _t(1, 4, 2, 300)), ValueError,
     "head dims must be"),
    ((_t(1, 4, 2, 8), _t(1, 5, 2, 8), _t(1, 4, 2, 8)), ValueError,
     "share \\(B, Skv, Hkv\\)"),
    ((_t(2, 4, 2, 8), _t(1, 4, 2, 8), _t(1, 4, 2, 8)), ValueError,
     "batch sizes"),
    ((_t(1, 4, 2, 8), _t(1, 4, 2, 8, device="meta"), _t(1, 4, 2, 8)),
     ValueError, "is on meta"),
    ((_t(1, 4, 2, 8).transpose(2, 3), _t(1, 4, 8, 2), _t(1, 4, 8, 2)),
     ValueError, "contiguous"),
])
def test_wrapper_rejects_bad_operands(args, exc, match):
    before = dict(ops.launches)
    with pytest.raises(exc, match=match):
        ops.flash_attention_fwd(*args)
    assert ops.launches == before


def test_wrapper_rejects_negative_window():
    q = _t(1, 4, 2, 8)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)


def _fake_card(monkeypatch):
    """Route the forward wrapper to the launch with the C library and the
    stream replaced by recorders; returns the list of the C entry's
    arguments."""
    calls = []

    def flash_attention_fwd(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_kernels", lambda: types.SimpleNamespace(
        flash_attention_fwd=flash_attention_fwd))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def _fused(B, S, H, Hkv, D, lead, dtype=torch.bfloat16):
    """q, k, v as views of one fused QKV buffer with ``lead`` elements
    before q in each row."""
    buf = torch.randn(B, S, lead + (H + 2 * Hkv) * D).to(dtype)
    cuts = [lead, lead + H * D, lead + (H + Hkv) * D, lead + (H + 2 * Hkv) * D]
    return [buf[..., a:b].unflatten(-1, (h, D))
            for a, b, h in zip(cuts, cuts[1:], (H, Hkv, Hkv))]


@pytest.mark.parametrize("make,width", [
    (lambda: [_t(1, 8, 4, 128, dtype=torch.bfloat16)] * 3, 16),
    (lambda: [_t(2, 8, 4, 36, dtype=torch.bfloat16)] * 3, 8),   # 72-B heads
    (lambda: [_t(2, 8, 4, 77, dtype=torch.bfloat16)] * 3, 2),   # 154-B heads
    (lambda: [_t(2, 8, 4, 77)] * 3, 4),                         # float32
    (lambda: [_t(2, 8, 4, 40, dtype=torch.bfloat16)] * 3, 16),  # 80-B heads
    (lambda: _fused(1, 8, 4, 2, 128, 0), 16),
    (lambda: _fused(1, 8, 4, 2, 128, 1), 2),     # one element before q
    (lambda: _fused(1, 8, 4, 2, 128, 4), 8),     # four: 8-byte rows
    # a size-1 dimension's stride is never applied: heads of 2 bytes'
    # stride on one head, and a 2-byte batch stride at B = 1
    (lambda: [_t(1, 8, 1, 36, dtype=torch.bfloat16)[:, :, :, :35]] * 3, 8),
    (lambda: [torch.zeros(2, 8, 1, 64, dtype=torch.bfloat16)
              .as_strided((1, 8, 1, 64), (1, 64, 64, 1))] * 3, 16),
    # a base 2 or 8 bytes past a 16-byte boundary
    (lambda: [torch.zeros(64, dtype=torch.bfloat16)[1:33]
              .reshape(1, 2, 2, 8)], 2),
    (lambda: [torch.zeros(64, dtype=torch.bfloat16)[4:36]
              .reshape(1, 2, 2, 8)], 8),
])
def test_copy_width_divides_every_row_start(make, width):
    """The bf16 kernel stages rows with the widest copy (16, 8 or 4 bytes
    a cp.async; 2 = plain loads) that divides each base address and each
    applied stride in bytes."""
    tensors = make()
    assert ops.copy_width(*tensors) == width
    for t in tensors:
        starts = [t.data_ptr() + t.element_size() * (
            b * t.stride(0) + s * t.stride(1) + h * t.stride(2))
            for b in range(t.shape[0]) for s in range(t.shape[1])
            for h in range(t.shape[2])]
        assert all(x % width == 0 for x in starts)


ACCEPTED = [
    # (B, Sq, Skv, H, Hkv, Dqk, Dv, window, layout): every shape the
    # wrapper takes reaches the launch, whatever the head dims (1, not a
    # multiple of 16, up to 256, Dv ≠ Dqk), lengths (ragged, Sq ≠ Skv),
    # GQA/MQA, windows and row alignment
    (1, 256, 256, 32, 8, 128, 128, 0, "contiguous"),
    (4, 128, 128, 32, 32, 80, 80, 0, "contiguous"),
    (2, 77, 77, 4, 4, 36, 36, 0, "contiguous"),
    (1, 64, 64, 4, 2, 77, 77, 0, "contiguous"),
    (1, 128, 128, 8, 1, 256, 256, 0, "contiguous"),
    (1, 40, 40, 4, 2, 48, 32, 0, "contiguous"),
    (1, 5, 5, 2, 1, 1, 1, 0, "contiguous"),
    (1, 160, 96, 4, 1, 64, 64, 48, "contiguous"),
    (1, 96, 160, 4, 2, 64, 64, 0, "contiguous"),
    (1, 256, 256, 32, 8, 128, 128, 0, "fused"),
    (2, 77, 77, 4, 2, 36, 36, 16, "fused"),
    (1, 64, 64, 4, 2, 40, 40, 0, "fused+1"),
    (1, 33, 33, 4, 2, 64, 64, 0, "offset+1"),
    # deepseek-v2-lite's MLA prefill: q and k of dn + dr = 192 from a
    # concatenation, v (dv 128) a strided view of the up-projection
    (1, 256, 256, 16, 16, 192, 128, 0, "mla"),
    # gemma3-12b's local layers at a 2048-token prefill, window 1024
    (1, 2048, 2048, 16, 8, 256, 256, 1024, "contiguous"),
]


def _accepted_operands(B, Sq, Skv, H, Hkv, Dqk, Dv, layout, dtype):
    if layout.startswith("fused"):
        lead = 1 if layout.endswith("+1") else 0
        return _fused(B, Sq, H, Hkv, Dqk, lead, dtype)
    if layout == "mla":                  # Dqk = Dnope + Drope, Dv = Dnope
        q = torch.randn(B, Sq, H, Dqk).to(dtype)
        up = torch.randn(B, Skv, Hkv, 2 * Dv).to(dtype)
        k = torch.cat([up[..., :Dv], torch.randn(B, Skv, 1, Dqk - Dv).to(
            dtype).expand(B, Skv, Hkv, Dqk - Dv)], dim=-1)
        return [q, k, up[..., Dv:]]
    shapes = [(B, Sq, H, Dqk), (B, Skv, Hkv, Dqk), (B, Skv, Hkv, Dv)]
    lead = 1 if layout == "offset+1" else 0
    return [torch.randn(math.prod(s) + lead).to(dtype)[lead:].reshape(s)
            for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dqk,Dv,window,layout", ACCEPTED)
def test_accepted_shapes_reach_the_kernel(monkeypatch, B, Sq, Skv, H, Hkv,
                                          Dqk, Dv, window, layout, dtype):
    """On a CUDA tensor (the dispatch mocked here) the wrapper refuses
    none of these: it launches once with the tensors in place, their
    strides, the copy width and the dtype code."""
    q, k, v = _accepted_operands(B, Sq, Skv, H, Hkv, Dqk, Dv, layout, dtype)
    calls = _fake_card(monkeypatch)
    before = ops.launches["flash_attention_fwd"]
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window,
                                     scale=0.125)
    assert ops.launches["flash_attention_fwd"] == before + 1
    (args,) = calls
    assert args[0] == (0 if dtype == torch.float32 else 1)
    assert args[1] == ops.copy_width(q, k, v)
    assert args[2:7] == tuple(t.data_ptr() for t in (q, k, v, o, lse))
    assert args[7:14] == (B, H, Hkv, Sq, Skv, Dqk, Dv)
    assert args[14:23] == (*q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3])
    assert args[23:] == (1, window, 0.125, 0)
    assert o.shape == (B, Sq, H, Dv) and o.dtype == dtype
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32


@pytest.mark.parametrize("name,dqk,dv,windows", [
    ("deepseek-v2-lite-16b", 80, 64, (0, 0)),
    ("gemma3-12b", 64, 64, (16, 0))])
def test_model_prefill_reaches_the_kernel(monkeypatch, name, dqk, dv,
                                          windows):
    """A prefill of the reduced deepseek-v2-lite (MLA: Dqk = dn + dr =
    64 + 16, Dv = 64, scale Dqk^-0.5) and gemma3-12b (a local layer with
    window 16, then a global one) on the mocked card: one launch a layer,
    with these head dims, scale and windows."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import reduced
    from repro_torch.models import model
    cfg = reduced(registry.get_arch(name))
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    calls = _fake_card(monkeypatch)
    model.forward(params, {"tokens": torch.ones(2, 24, dtype=torch.long)},
                  cfg)
    assert len(calls) == cfg.n_layers
    for args, window in zip(calls, windows):
        B, H, Hkv, Sq, Skv, Dqk, Dv = args[7:14]
        assert (B, H, Sq, Skv, Dqk, Dv) == (2, cfg.n_heads, 24, 24, dqk, dv)
        assert args[23:25] == (1, window)
        assert args[25] == pytest.approx(dqk ** -0.5)
