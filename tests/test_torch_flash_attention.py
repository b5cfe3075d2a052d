"""The port's flash-attention forward (on CPU tensors: its plain PyTorch
version) against the JAX Pallas kernel ``flash_attention_fwd_bhsd`` in
interpret mode, and the model-layout wrappers against each other.

The JAX side takes the ``(B, H, S, D)`` layout its kernel reads; the port
reads the model layout ``(B, S, H, D)`` itself.  Tolerances: float32 1e-5
(the two sum the same float32 terms in another order); bfloat16 one bf16
ulp of ``o`` (the same float32 value, within summation order, rounded once
to bfloat16 can land one ulp apart) and 1e-5 for the float32 ``lse``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_fwd_bhsd)
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

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
