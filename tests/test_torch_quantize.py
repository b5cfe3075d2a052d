"""The port's wire-compression wrappers (on CPU tensors: their plain PyTorch
versions) against the JAX Pallas quantize kernels in interpret mode, and
its scale/threshold selection against ``repro.kernels.quantize.ops``.

Every comparison is exact: both sides do the same float32 operations in
the same order (a true division, round half to even, the clip before the
int8 cast; one product then one rounding for dequantize; a compare and a
select for the mask), so codes, values and scales agree to the bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.quantize import kernel as jkernel  # noqa: E402
from repro.kernels.quantize import ops as jops  # noqa: E402
from repro_torch.kernels.quantize import ops  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

ROWS = (1, 3, 100, 1000)
COLS = (128, 384, 640)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rows(rows, cols, seed, n=None):
    """float32 numpy rows ~ 3·N(0, 1); columns [n, cols) poisoned with 1e9
    when ``n`` is given (the selection helpers must never read them)."""
    x = 3.0 * np.random.default_rng(seed).standard_normal(
        (rows, cols), dtype=np.float32)
    if n is not None:
        x[:, n:] = 1e9
    return x


def _both(x, dtype):
    """The same values as a JAX array and a port tensor of ``dtype``."""
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(x).to(DTYPES[dtype][1])


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_quantize_matches_pallas(rows, cols, dtype, qmax):
    x = _rows(rows, cols, 0)
    jx, tx = _both(x, dtype)
    scale = np.array(jops.row_scales(jx, cols, qmax))
    want = jkernel.quantize_2d(jx, jnp.asarray(scale), qmax=qmax,
                               interpret=True)
    before = dict(ops.launches)
    got = ops.quantize_2d(tx, torch.from_numpy(scale), qmax=qmax)
    assert got.dtype == torch.int8 and got.shape == (rows, cols)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.abs().max()) <= qmax
    assert ops.launches == before            # CPU tensors launch no kernel


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_dequantize_matches_pallas(rows, cols, dtype):
    x = _rows(rows, cols, 1)
    scale = np.array(jops.row_scales(jnp.asarray(x), cols, 127))
    q = np.array(jkernel.quantize_2d(jnp.asarray(x), jnp.asarray(scale),
                                     interpret=True))
    want = jkernel.dequantize_2d(jnp.asarray(q), jnp.asarray(scale),
                                 out_dtype=DTYPES[dtype][0], interpret=True)
    got = ops.dequantize_2d(torch.from_numpy(q), torch.from_numpy(scale),
                            out_dtype=DTYPES[dtype][1])
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_topk_mask_matches_pallas(rows, cols, dtype):
    x = _rows(rows, cols, 2)
    x[:, 5] = x[:, 6]                        # a tie at the threshold
    jx, tx = _both(x, dtype)
    k = max(1, cols // 20)
    thresh = np.array(jops.topk_thresholds(jx, cols, k))
    want = jkernel.topk_mask_2d(jx, jnp.asarray(thresh), interpret=True)
    got = ops.topk_mask_2d(tx, torch.from_numpy(thresh))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    # ties survive: at least k elements per row
    assert (np.count_nonzero(_np(got), axis=1) >= k).all()


@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("rows,n,p", [(1, 100, 128), (4, 200, 256),
                                      (10, 610, 640), (3, 4554, 4608)])
def test_selection_matches_reference_with_poisoned_pad(rows, n, p, qmax):
    x = _rows(rows, p, 3, n=n)
    tx = torch.from_numpy(x)
    amax = ops.masked_abs_rowmax(tx, n)
    np.testing.assert_array_equal(
        amax.numpy(), np.asarray(jops.masked_abs_rowmax(jnp.asarray(x), n)))
    np.testing.assert_array_equal(
        amax.numpy(), np.abs(x[:, :n]).max(axis=1, keepdims=True))
    np.testing.assert_array_equal(
        ops.row_scales(tx, n, qmax).numpy(),
        np.asarray(jops.row_scales(jnp.asarray(x), n, qmax)))
    k = max(1, round(0.05 * n))
    th = ops.topk_thresholds(tx, n, k)
    assert th.shape == (rows, 1) and th.is_contiguous()
    np.testing.assert_array_equal(
        th.numpy(), np.asarray(jops.topk_thresholds(jnp.asarray(x), n, k)))
    assert float(th.max()) < 1e9             # the pad never takes a slot


@pytest.mark.parametrize("qmax", [127, 7])
def test_half_ties_round_to_even_and_zero_row(qmax):
    """x / s lands exactly on k + ½ (s = 1/8, a power of two, so the
    division is exact); both packages round every tie to the even code.
    An all-zero row gets the eps scale and codes to zero."""
    s = 0.125
    ties = (np.arange(-qmax, qmax) + 0.5) * s
    x = np.zeros((2, 256), np.float32)
    x[0, :ties.size] = ties
    x[0, -1] = qmax * s                     # amax → scale exactly 1/8
    tx = torch.from_numpy(x)
    scale = ops.row_scales(tx, 256, qmax)
    assert float(scale[0]) == s and float(scale[1]) == np.float32(1e-12)
    got = ops.quantize_2d(tx, scale, qmax=qmax)
    want = np.asarray(jkernel.quantize_2d(jnp.asarray(x),
                                          jnp.asarray(scale.numpy()),
                                          qmax=qmax, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, :ties.size].numpy(),
                                  np.round(ties / s).astype(np.int8))
    assert (got[0, :ties.size].numpy() % 2 == 0).all()
    assert not got[1].any()
    back = ops.dequantize_2d(got, scale)
    assert not back[1].any()


@pytest.mark.parametrize("case", ["cols", "dtype", "code_dtype", "scale",
                                  "layout", "qmax", "out_dtype", "k"])
def test_wrappers_reject_bad_operands(case):
    x = torch.zeros(4, 128)
    scale = torch.ones(4, 1)
    if case == "cols":
        with pytest.raises(ValueError, match="128"):
            ops.quantize_2d(torch.zeros(4, 100), scale)
    elif case == "dtype":
        with pytest.raises(TypeError):
            ops.topk_mask_2d(x.double(), scale)
    elif case == "code_dtype":
        with pytest.raises(TypeError):
            ops.dequantize_2d(x, scale)
    elif case == "scale":
        with pytest.raises(ValueError, match="scale"):
            ops.quantize_2d(x, torch.ones(4))
        with pytest.raises(ValueError, match="thresh"):
            ops.topk_mask_2d(x, torch.ones(4, 1, dtype=torch.float64))
    elif case == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            ops.quantize_2d(torch.zeros(128, 4).t(), scale)
    elif case == "qmax":
        with pytest.raises(ValueError, match="qmax"):
            ops.quantize_2d(x, scale, qmax=200)
    elif case == "out_dtype":
        with pytest.raises(TypeError, match="out_dtype"):
            ops.dequantize_2d(torch.zeros(4, 128, dtype=torch.int8), scale,
                              out_dtype=torch.float16)
    else:
        with pytest.raises(ValueError, match="k must be"):
            ops.topk_thresholds(x, 100, 101)
