"""The port's calibrated-update wrappers (on CPU tensors: their plain
PyTorch versions) against the JAX Pallas kernels in interpret mode followed
by the reference's K_i ``where`` mask — the shape/dtype sweep of
tests/test_kernels.py, with a per-row η whose zero rows stay unchanged."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.calibrated_update.kernel import (  # noqa: E402
    calibrated_update_2d, calibrated_update_prox_2d)
from repro_torch.kernels.calibrated_update import ops  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

LR, LAM, MU = 0.03, 0.7, 0.1
SHAPES = [(rows, cols) for rows in (3, 8, 100, 512, 1000)
          for cols in (128, 256, 384)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the reference test's tolerances: f32 1e-5; bf16 one bf16 ulp (2⁻⁸), since
# a 1-ulp f32 difference in the kernel's arithmetic can straddle a bf16
# rounding boundary
TOL = {"float32": 1e-5, "bfloat16": 2 ** -8}


def _operands(rows, cols, dtype, n, seed):
    """``n`` (rows, cols) float32 numpy operands, the same operands as port
    tensors of ``dtype``, and the mixed per-row step: every third row
    inactive (η = 0)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((rows, cols), dtype=np.float32)
            for _ in range(n)]
    active = np.arange(rows) % 3 != 1
    eta = np.where(active, np.float32(LR), np.float32(0.0))
    return (arrs, [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrs],
            active, torch.from_numpy(eta))


@functools.partial(jax.jit, static_argnames="dtype")
def _pallas_masked(active, x, g, c, x0=None, *, dtype):
    """The reference's TPU step: the Pallas kernel, then the K_i select."""
    x, g, c = (a.astype(DTYPES[dtype][0]) for a in (x, g, c))
    if x0 is None:
        upd = calibrated_update_2d(x, g, c, LR, LAM, interpret=True)
    else:
        upd = calibrated_update_prox_2d(x, g, c,
                                        x0.astype(DTYPES[dtype][0]), LR, LAM,
                                        MU, interpret=True)
    return jnp.where(active[:, None], upd, x).astype(jnp.float32)


def _compare(got, want, x, active, dtype):
    assert got.dtype == x.dtype and got.shape == x.shape
    got32 = got.float().numpy()
    np.testing.assert_allclose(got32, np.asarray(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # an inactive row (η = 0) returns x exactly
    np.testing.assert_array_equal(got32[~active], x.float().numpy()[~active])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_calibrated_update_matches_pallas(rows, cols, dtype):
    arrs, (x, g, c), active, eta = _operands(rows, cols, dtype, 3, 0)
    want = _pallas_masked(active, *arrs, dtype=dtype)
    before = dict(ops.launches)
    got = ops.calibrated_update(x, g, c, eta, LAM)
    _compare(got, want, x, active, dtype)
    assert ops.launches == before        # CPU tensors launch no kernel


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_calibrated_update_prox_matches_pallas(rows, cols, dtype):
    arrs, (x, g, c, x0), active, eta = _operands(rows, cols, dtype, 4, 1)
    want = _pallas_masked(active, *arrs, dtype=dtype)
    before = dict(ops.launches)
    got = ops.calibrated_update_prox(x, g, c, x0, eta, LAM, MU)
    _compare(got, want, x, active, dtype)
    assert ops.launches == before


@pytest.mark.parametrize("prox", [False, True])
def test_absent_correction_equals_zero_correction(prox):
    """``c=None`` (ν-free algorithms: the kernel reads no c) gives exactly
    the reference's c = 0, λ = 0 feed."""
    _, (x, g, c, x0), _, eta = _operands(8, 256, "float32", 4, 2)
    zero = torch.zeros_like(c)
    if prox:
        got = ops.calibrated_update_prox(x, g, None, x0, eta, 0.0, MU)
        want = ops.calibrated_update_prox(x, g, zero, x0, eta, 0.0, MU)
    else:
        got = ops.calibrated_update(x, g, None, eta, 0.0)
        want = ops.calibrated_update(x, g, zero, eta, 0.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["cols", "dtype", "shape", "layout", "eta",
                                  "x0"])
def test_wrapper_rejects_bad_operands(case):
    x = torch.zeros(4, 128)
    g, c, eta = torch.zeros_like(x), torch.zeros_like(x), torch.zeros(4)
    if case == "cols":
        with pytest.raises(ValueError, match="128"):
            ops.calibrated_update(torch.zeros(4, 100), torch.zeros(4, 100),
                                  None, eta, 0.0)
    elif case == "dtype":
        with pytest.raises(TypeError):
            ops.calibrated_update(x.double(), g.double(), None, eta, 0.0)
    elif case == "shape":
        with pytest.raises(ValueError, match="expected"):
            ops.calibrated_update(x, torch.zeros(4, 256), c, eta, 0.0)
    elif case == "layout":
        with pytest.raises(ValueError, match="contiguous"):
            ops.calibrated_update(x, g, torch.zeros(128, 4).t(), eta, 0.0)
    elif case == "eta":
        with pytest.raises(ValueError, match="eta"):
            ops.calibrated_update(x, g, c, torch.zeros(4, dtype=torch.float64),
                                  0.0)
    else:
        with pytest.raises(ValueError, match="x0"):
            ops.calibrated_update_prox(x, g, c, None, eta, 0.0, MU)
