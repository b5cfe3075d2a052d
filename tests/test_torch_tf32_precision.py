"""Why the float32 backward kernels take three TF32 products a product.

The float32 instances of the attention backward (``dq_kernel_tf32`` and
``dkv_kernel_tf32`` in ``csrc/flash_attention_bwd.cu``) run every product
on the tensor cores in TF32, whose operands keep 10 of float32's 23
mantissa bits.  Each float32 operand x is split into x_hi = rna(x) and
x_lo = rna(x − x_hi), rna rounding to nearest with ties away from zero on
the 13 low mantissa bits, and a·b is taken as a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi (``csrc/tf32_tiles.cuh``).  The kernels cannot run here, so this
file emulates their rounding on the CPU: the plain backward's formulas
(those of ``ref.attention_bwd``: the scores, dP, dq, dk and dv products),
each product taken on TF32-rounded operands in float32 (a product of two
TF32 values is exact in float32), with three products and with one.

Held to ``ATTN_BWD_TOL`` of ``chip_smoke.py`` — the tolerance the card's
check holds the kernels to, 2e-5 of each gradient's largest entry — against
the float32 plain version: three products stay within it, one does not.
Shapes: the training path's (gemma-2b: 8 heads, 1 kv head, head dim 256,
S 128) cut to one batch row, the ``--small`` model's local step (head dim
32) and a windowed GQA shape at zamba2's head dim 80.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [
    # B, S, H, Hkv, D, window
    (1, 128, 8, 1, 256, 0),      # the training path's step, one row
    (8, 32, 2, 1, 32, 0),        # the --small model's step
    (2, 96, 4, 2, 80, 16),       # GQA under a window, head dim 80
]


def _attn_bwd_tol() -> float:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.ATTN_BWD_TOL


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32: nearest, ties away from zero, on the
    13 low mantissa bits (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor,
            terms: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` in float32 from TF32 operands: ``terms`` = 3
    takes a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, small terms first; 1 takes
    a_hi·b_hi alone."""
    a_hi, b_hi = tf32(a), tf32(b)
    if terms == 1:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def emulated_bwd(q, k, v, do, lse, delta, window, terms):
    """The plain backward's formulas with every product in TF32 terms, as
    the kernels order them: s = scale·(q·kᵀ), dq = scale·(ds·k),
    dk = scale·(dsᵀ·q)."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    scale = D ** -0.5
    qf = q.reshape(B, Sq, Hkv, g, D)
    dof = do.reshape(B, Sq, Hkv, g, Dv)
    s = scale * product("bqhgd,bkhd->bhgqk", qf, k, terms)
    mask = ref.visible(Sq, Skv, True, window)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1)), 0.0)
    dp = product("bqhgd,bkhd->bhgqk", dof, v, terms)
    ds = p * (dp - delta.reshape(B, Hkv, g, Sq, 1))
    dq = scale * product("bhgqk,bkhd->bqhgd", ds, k, terms)
    dk = scale * product("bhgqk,bqhgd->bkhd", ds, qf, terms)
    dv = product("bhgqk,bqhgd->bkhd", p, dof, terms)
    return dq.reshape(B, Sq, H, D), dk, dv


def _errors(shape, terms):
    """Each gradient's largest |emulated − plain| over its largest
    |plain| entry."""
    B, S, H, Hkv, D, window = shape
    rng = np.random.default_rng(S + D + H)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                             (B, S, H, D)))
    o, lse = ref.attention_fwd(q, k, v, causal=True, window=window)
    want = ref.attention_bwd(q, k, v, o, lse, do, causal=True,
                             window=window)
    got = emulated_bwd(q, k, v, do, lse, ref.row_delta(do, o), window,
                       terms)
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("shape", SHAPES, ids=["train", "small", "gqa80"])
def test_three_tf32_products_hold_the_backward_tolerance(shape):
    tol = _attn_bwd_tol()
    errors = _errors(shape, terms=3)
    assert max(errors) <= tol, dict(zip(("dq", "dk", "dv"), errors))


@pytest.mark.parametrize("shape", SHAPES, ids=["train", "small", "gqa80"])
def test_one_tf32_product_misses_the_backward_tolerance(shape):
    tol = _attn_bwd_tol()
    errors = _errors(shape, terms=1)
    assert min(errors) > tol, dict(zip(("dq", "dk", "dv"), errors))


def test_tf32_rounds_to_nearest_ties_away():
    """13 low mantissa bits dropped with rounding: below half an ulp of
    TF32 down, at or above half up in magnitude, for either sign."""
    one = 1.0
    ulp = 2.0 ** -10                          # TF32's ulp at 1
    x = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, one + 0.51 * ulp,
                      -(one + 0.5 * ulp), 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    lo = tf32(x - tf32(x))
    assert torch.equal(tf32(lo), lo)          # the residue is TF32 too
