"""Why the float32 tensor-core kernels take three TF32 products a product.

The float32 instances of the attention backward (``dq_kernel_tf32`` and
``dkv_kernel_tf32`` in ``csrc/flash_attention_bwd.cu``), of the attention
forward (``flash_fwd_kernel_tf32`` in ``csrc/flash_attention.cu``), the
SSD scan (``ssd_scan_kernel_mma`` in ``ssd_scan/csrc/ssd_scan.cu``) and the
SSD backward's dstate and chunk kernels (``ssd_scan/csrc/ssd_scan_bwd.cu``)
run their products on the tensor cores in TF32, whose operands keep 10 of
float32's 23 mantissa bits.  Each float32 operand x is split into
x_hi = rna(x) and x_lo = rna(x − x_hi), rna rounding to nearest with ties
away from zero on the 13 low mantissa bits, and a·b is taken as
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (``kernels/common/csrc/tf32_tiles.cuh``).
The kernels cannot run here, so this file emulates their rounding on the
CPU: the plain versions' formulas, each product taken on TF32-rounded
operands in float32 (a product of two TF32 values is exact in float32),
with three products and with one — the forward's P·V summed a kv tile at a
time into the rescaled O, as the kernel sums each tile in a fresh
fragment; the SSD's C·Bᵀ exact for bfloat16 inputs (the kernel's bf16
product), its other products in TF32 terms, a bfloat16 x, B or C being
exactly TF32 (no lo half); the SSD backward's products likewise.

Held to the tolerances the card's checks hold the kernels to
(``chip_smoke.py``): the backward's ``ATTN_BWD_TOL``, 2e-5 of each
gradient's largest entry; the forward's ``ATTN_TOL``, 1e-5·(1 + |o|) for o
and 1e-5·(1 + |lse|) for lse; the SSD's ``SSD_TOL``, 2e-4 of the largest
entry of y and of the state; the SSD backward's ``SSD_BWD_TOL`` (1e-4 of
each gradient's largest entry, ``SSD_BWD_DA_TOL`` for dA, one bfloat16 ulp
more for a bfloat16 dx, dB or dC), the dstate, chain, chunk and reduce
stages together — against the float32 plain versions: three products
stay within each, one does not (with bfloat16 SSD inputs, whose exact
operands leave one side unrounded, at two of three shapes).
Attention shapes: the training
path's (gemma-2b: 8 heads, 1 kv head, head dim 256, S 128) cut to one
batch row, the ``--small`` model's local step (head dim 32) and a windowed
GQA shape at zamba2's head dim 80; SSD shapes: the small cases of
``chip_smoke.SSD_SHAPES`` in both input types.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [
    # B, S, H, Hkv, D, window
    (1, 128, 8, 1, 256, 0),      # the training path's step, one row
    (8, 32, 2, 1, 32, 0),        # the --small model's step
    (2, 96, 4, 2, 80, 16),       # GQA under a window, head dim 80
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _attn_bwd_tol() -> float:
    return _chip_smoke().ATTN_BWD_TOL


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


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def emulated_fwd(q, k, v, window, terms, block_keys):
    """The plain forward's formulas as the float32 kernel orders them: q
    scaled first (one float32 rounding), s = (q·scale)·kᵀ in TF32 terms,
    hidden keys at −∞ with the row max starting at NEG_INF, then an online
    softmax over kv tiles of ``block_keys`` keys, each tile's P·V (TF32
    terms) added to the rescaled O."""
    B, S, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    g = H // Hkv
    qf = (q * D ** -0.5).reshape(B, S, Hkv, g, D)
    s = product("bqhgd,bkhd->bhgqk", qf, k, terms)
    s = torch.where(ref.visible(S, S, True, window), s, -torch.inf)
    m = torch.full((B, Hkv, g, S), ref.NEG_INF)
    l = torch.zeros(B, Hkv, g, S)
    o = torch.zeros(B, Hkv, g, S, Dv)
    for k0 in range(0, S, block_keys):
        st = s[..., k0:k0 + block_keys]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = alpha * l + p.sum(-1)
        o = alpha[..., None] * o + product(
            "bhgqk,bkhd->bhgqd", p, v[:, k0:k0 + block_keys], terms)
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    o = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv)
    return o, (m + torch.log(l)).reshape(B, H, S)


def _fwd_misses(shape, terms):
    """(o, lse): the largest |emulated − plain| over its ATTN_TOL[float32]
    allowance, 1e-5·(1 + |plain|)."""
    smoke = _chip_smoke()
    tol = smoke.ATTN_TOL[torch.float32]
    B, S, H, Hkv, D, window = shape
    rng = np.random.default_rng(S + D + H + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want_o, want_lse = ref.attention_fwd(q, k, v, causal=True,
                                         window=window)
    bucket = min(b for b in smoke.BWD_HEAD_BUCKETS if b >= D)
    got_o, got_lse = emulated_fwd(q, k, v, window, terms,
                                  smoke.FWD_TF32_BLOCK_KEYS[bucket])
    return [float(((g - w).abs() / (tol * (1 + w.abs()))).max())
            for g, w in ((got_o, want_o), (got_lse, want_lse))]


@pytest.mark.parametrize("shape", SHAPES, ids=["train", "small", "gqa80"])
def test_three_tf32_products_hold_the_forward_tolerance(shape):
    misses = _fwd_misses(shape, terms=3)
    assert max(misses) <= 1.0, dict(zip(("o", "lse"), misses))


@pytest.mark.parametrize("shape", SHAPES, ids=["train", "small", "gqa80"])
def test_one_tf32_product_misses_the_forward_tolerance(shape):
    misses = _fwd_misses(shape, terms=1)
    assert min(misses) > 1.0, dict(zip(("o", "lse"), misses))


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def emulated_ssd(x, dt, A, B, C, chunk, terms):
    """``ssd_ref.ssd_chunked``'s formulas with the kernel's products: C·Bᵀ
    exact in float32 for bfloat16 inputs (one bf16 product), else in TF32
    terms; y's diagonal term W·xdt and ΔS = xdtᵀ·(w ∘ B) in TF32 terms —
    for bfloat16 inputs as (W ∘ dt)·x and (x ∘ dt·w)ᵀ·B, x and B exactly
    TF32 — and C·S_{c−1}ᵀ; exp(cum) applied after C·S_{c−1}ᵀ, the
    recurrence over the chunks in float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = min(chunk, l)
    c = l // L
    rep = h // g
    xb = (x.float() * dt[..., None]).reshape(b, c, L, h, p)
    dA = (dt * A[None, None, :]).reshape(b, c, L, h).permute(0, 1, 3, 2)
    Bc = B.reshape(b, c, L, g, n).repeat_interleave(rep, dim=3).float()
    Cc = C.reshape(b, c, L, g, n).repeat_interleave(rep, dim=3).float()
    cum = torch.cumsum(dA, dim=-1)                            # (b,c,h,L)
    lmat = torch.exp(ssd_ref._segsum(dA))
    w = torch.exp(cum[..., -1:] - cum).permute(0, 1, 3, 2)    # (b,c,L,h)
    if x.dtype == torch.bfloat16:
        xr = x.float().reshape(b, c, L, h, p)
        dtc = dt.reshape(b, c, L, h)
        cb = torch.einsum("bczhn,bcshn->bchzs", Cc, Bc)
        wdt = cb * lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
        y = product("bchzs,bcshp->bczhp", wdt, xr, terms)
        s_chunk = product("bcshp,bcshn->bchpn", xr * (dtc * w)[..., None],
                          Bc, terms)
    else:
        cb = product("bczhn,bcshn->bchzs", Cc, Bc, terms)
        y = product("bchzs,bcshp->bczhp", cb * lmat, xb, terms)
        s_chunk = product("bcshp,bcshn->bchpn", xb, Bc * w[..., None],
                          terms)
    decay = torch.exp(cum[..., -1])
    S = torch.zeros(b, h, p, n)
    for ci in range(c):
        if ci:
            off = product("bzhn,bhpn->bzhp", Cc[:, ci], S, terms)
            y[:, ci] += torch.exp(cum[:, ci]).permute(0, 2, 1)[..., None] * off
        S = s_chunk[:, ci] + decay[:, ci, :, None, None] * S
    return y.reshape(b, l, h, p), S


SSD_SMALL = [(2, 64, 4, 16, 2, 8, 16), (1, 77, 4, 16, 2, 8, 128),
             (1, 256, 4, 128, 1, 128, 128)]


def _ssd_errors(shape, dtype, terms):
    """y's and the state's largest |emulated − plain| over their largest
    |plain| entry (chip_smoke's phase 9 measure)."""
    b, l, h, p, g, n, chunk = shape
    rng = np.random.default_rng(l + p + n)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, l, h), np.float32)))
    A = -torch.exp(0.5 * torch.from_numpy(rng.standard_normal(h, np.float32)))
    B, C = (torch.from_numpy(rng.standard_normal((b, l, g, n), np.float32))
            .to(dtype) for _ in range(2))
    x = x.to(dtype)
    want = ssd_ref.ssd_chunked(x, dt, A, B, C, chunk)
    got = emulated_ssd(x, dt, A, B, C, chunk, terms)
    return [float((gt - w).abs().max() / w.abs().max())
            for gt, w in zip(got, want)]


def test_ssd_small_shapes_are_chip_smokes():
    assert all(shape in _chip_smoke().SSD_SHAPES for shape in SSD_SMALL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SMALL, ids=["chunks4", "ragged77",
                                                  "pn128"])
def test_three_tf32_products_hold_the_ssd_tolerance(shape, dtype):
    errors = _ssd_errors(shape, dtype, terms=3)
    assert max(errors) <= _chip_smoke().SSD_TOL, dict(zip(("y", "state"),
                                                          errors))


@pytest.mark.parametrize("shape", SSD_SMALL, ids=["chunks4", "ragged77",
                                                  "pn128"])
def test_one_tf32_product_misses_the_ssd_tolerance(shape):
    errors = _ssd_errors(shape, torch.float32, terms=1)
    assert max(errors) > _chip_smoke().SSD_TOL, dict(zip(("y", "state"),
                                                         errors))


def test_one_tf32_product_misses_the_ssd_tolerance_with_bf16_inputs():
    """With bfloat16 inputs one operand of every product is exact (x, B
    or C), so a single TF32 product rounds only the other: it still misses
    SSD_TOL at two of the three shapes (and lands at ~0.95 of it at the
    ragged 77), where three stay ~1000× inside."""
    tol = _chip_smoke().SSD_TOL
    one = {shape: max(_ssd_errors(shape, torch.bfloat16, terms=1))
           for shape in SSD_SMALL}
    assert sum(err > tol for err in one.values()) >= 2, one
    assert min(one.values()) > 0.5 * tol, one


# ---------------------------------------------------------------------------
# the SSD backward
# ---------------------------------------------------------------------------

def emulated_bwd_chunk(x, dt, A, B, C, dy, states, final, G, L, terms):
    """``ssd_ref.bwd_chunk``'s formulas with the chunk kernel's products
    (``product``; a bfloat16 operand has no lo half, so three terms are the
    kernel's two): W = C·Bᵀ (exact for bfloat16 inputs) ∘ E, V = (dy·xᵀ) ∘ (dt_s E), the
    scalars on the side of the float32 operand so that x, B and C stay
    exact in bfloat16; d(xdt) = Wᵀ·dy + w ∘ (B·G_cᵀ), dB = Vᵀ·C +
    (dt·w) ∘ (x·G_c), dC = V·B + exp(cum) ∘ (dy·S_{c−1}); the rest
    (row dots, dcum, ddA, ddt, dA) in float32 as the plain version."""
    b, l, h, p = x.shape
    c = l // L
    rep = h // B.shape[2]
    dt_t, cum = ssd_ref._chunked(dt, A, L)                    # (b,c,h,L)
    xc = x.float().reshape(b, c, L, h, p)
    dtc = dt.float().reshape(b, c, L, h)
    Bc, Cc = ssd_ref._heads(B, c, L, rep), ssd_ref._heads(C, c, L, rep)
    dyc = dy.float().reshape(b, c, L, h, p)
    E = torch.exp(ssd_ref._segsum(dt_t * ssd_ref._a_rows(A, b)[:, None, :,
                                                                None]))
    dts = dt_t[:, :, :, None, :]                              # by s
    W = product("bczhn,bcshn->bchzs", Cc, Bc, terms) * E
    V = product("bczhp,bcshp->bchzs", dyc, xc, terms) * (dts * E)
    wend = torch.exp(cum[..., -1:] - cum)
    wsb = wend.permute(0, 1, 3, 2)[..., None]                 # (b,c,L,h,1)
    dxdt = (product("bchzs,bczhp->bcshp", W, dyc, terms)
            + wsb * product("bcshn,bchpn->bcshp", Bc, G, terms))
    dBh = (product("bchzs,bczhn->bcshn", V, Cc, terms)
           + wsb * dtc[..., None] * product("bcshp,bchpn->bcshn", xc, G,
                                            terms))
    ez = torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    dCh = (product("bchzs,bcshn->bczhn", V, Bc, terms)
           + ez * product("bczhp,bchpn->bczhn", dyc, states, terms))
    rx = (xc * dxdt).sum(-1)                                  # (b,c,L,h)
    dcum = ((Cc * dCh).sum(-1) - dtc * rx).permute(0, 1, 3, 2)
    S_next = torch.cat([states[:, 1:], final[:, None]], dim=1)
    dcum[..., -1] += (G * S_next).sum((-2, -1))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = rx.permute(0, 1, 3, 2) + ddA * ssd_ref._a_rows(A, b)[:, None, :,
                                                              None]
    dA = (ddA * dt_t).sum(-1)
    dx = (dxdt * dtc[..., None]).reshape(b, l, h, p).to(x.dtype)
    return (dx, ddt.permute(0, 1, 3, 2).reshape(b, l, h),
            dBh.reshape(b, l, h, -1), dCh.reshape(b, l, h, -1), dA)


def emulated_ssd_bwd(x, dt, A, B, C, chunk, dy, dS_last, terms):
    """The four backward kernels: ΔG = (exp(cum) ∘ dy)ᵀ·C with dstate's
    products, the chain and the reduce in float32 (``ssd_ref.bwd_chain``,
    ``bwd_reduce``), the chunk kernel as ``emulated_bwd_chunk``; the
    forward's states from the plain version."""
    b, l, h, p = x.shape
    L = min(chunk, l)
    c = l // L
    _, final, states = ssd_ref.chunk_states(x, dt, A, B, C, chunk)
    _, cum = ssd_ref._chunked(dt, A, L)
    Cc = ssd_ref._heads(C, c, L, h // C.shape[2])
    edy = (torch.exp(cum).permute(0, 1, 3, 2)[..., None]
           * dy.float().reshape(b, c, L, h, p))
    dG = product("bczhp,bczhn->bchpn", edy, Cc, terms)
    G = ssd_ref.bwd_chain(dG, torch.exp(cum[..., -1]), dS_last)
    dx, ddt, dBh, dCh, dA_chunks = emulated_bwd_chunk(
        x, dt, A, B, C, dy, states, final, G, L, terms)
    dB, dC, dA = ssd_ref.bwd_reduce(dBh, dCh, dA_chunks, B.shape[2],
                                    B.dtype, A.dim() == 1)
    return dx, ddt, dA, dB, dC


def _ssd_bwd_misses(shape, dtype, terms):
    """Each gradient's largest |emulated − plain| over its allowance in
    phase 9 (chip_smoke's SSD_BWD_TOL, SSD_BWD_DA_TOL for dA, plus
    SSD_BWD_BF16_TOL for a bfloat16 dx, dB or dC), times its largest
    |plain| entry: above 1 misses."""
    smoke = _chip_smoke()
    b, l, h, p, g, n, chunk = shape
    rng = np.random.default_rng(l + p + n + 7)
    x = torch.from_numpy(rng.standard_normal((b, l, h, p), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, l, h), np.float32)))
    A = -torch.exp(0.5 * torch.from_numpy(rng.standard_normal(h, np.float32)))
    B, C = (torch.from_numpy(rng.standard_normal((b, l, g, n), np.float32))
            .to(dtype) for _ in range(2))
    x = x.to(dtype)
    dy = torch.from_numpy(rng.standard_normal((b, l, h, p), np.float32))
    dS = torch.from_numpy(rng.standard_normal((b, h, p, n), np.float32))
    want = ssd_ref.ssd_chunked_bwd(x, dt, A, B, C, chunk, dy, dS)
    got = emulated_ssd_bwd(x, dt, A, B, C, chunk, dy, dS, terms)
    misses = {}
    for name, gt, w in zip(smoke.SSD_BWD_NAMES, got, want):
        assert gt.shape == w.shape and gt.dtype == w.dtype, name
        tol = smoke.SSD_BWD_DA_TOL if name == "dA" else smoke.SSD_BWD_TOL
        if gt.dtype == torch.bfloat16:
            tol += smoke.SSD_BWD_BF16_TOL
        misses[name] = float((gt.float() - w.float()).abs().max()
                             / (tol * w.float().abs().max()))
    return misses


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SMALL, ids=["chunks4", "ragged77",
                                                  "pn128"])
def test_split_tf32_products_hold_the_ssd_backward_tolerance(shape, dtype):
    """The split products stay within half of the phase-9 allowance."""
    misses = _ssd_bwd_misses(shape, dtype, terms=3)
    assert max(misses.values()) <= 0.5, misses


def test_one_tf32_product_misses_the_ssd_backward_tolerance():
    """One TF32 product (each operand rounded to TF32) misses the phase-9
    allowance at every small shape, by more than 7×."""
    worst = {shape: max(_ssd_bwd_misses(shape, torch.float32, terms=1)
                        .values()) for shape in SSD_SMALL}
    assert min(worst.values()) > 7.0, worst
