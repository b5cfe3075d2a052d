"""The port's data path and flat layout against the JAX package: the
synthetic task, the batch streams and the K_i schedule are numpy in both,
so they must agree bit for bit; ``FlatSpec``/``ravel`` must lay parameters
out identically so a flat buffer means the same thing in both."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import flat as jflat  # noqa: E402
from repro.data.partition import gaussian_k_schedule as j_k_schedule  # noqa: E402
from repro.data.pipeline import FederatedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import fedprox_synthetic as j_synthetic  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import flat as tflat  # noqa: E402
from repro_torch.data import FederatedBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.data.partition import gaussian_k_schedule  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M = 4


def _seed_of(key) -> int:
    """The integer the JAX generator derives from its key."""
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1))


@pytest.fixture(scope="module")
def task():
    key = jax.random.PRNGKey(3)
    jdata, jparts = j_synthetic(key, M, d=12, n_classes=5, n_per_client=30)
    data, parts = fedprox_synthetic(_seed_of(key), M, d=12, n_classes=5,
                                    n_per_client=30)
    return jdata, jparts, data, parts


def test_fedprox_synthetic_bit_identical(task):
    jdata, jparts, data, parts = task
    assert data.x.dtype == torch.float32 and data.y.dtype == torch.int32
    np.testing.assert_array_equal(data.x.numpy(), np.asarray(jdata.x))
    np.testing.assert_array_equal(data.y.numpy(), np.asarray(jdata.y))
    assert len(parts) == len(jparts)
    for p, jp in zip(parts, jparts):
        np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("seed", [0, 5])
def test_batcher_round_and_chunk_bit_identical(task, seed):
    jdata, jparts, data, parts = task
    jb = JBatcher(jdata, jparts, batch_size=6, seed=seed)
    tb = FederatedBatcher(data, parts, batch_size=6, seed=seed, device="cpu")
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    for t in (0, 3):
        got, want = tb.round_batches(t, 5), jb.round_batches(t, 5)
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got, want = tb.chunk_batches(2, 3, 4), jb.chunk_batches(2, 3, 4)
    assert got["x"].shape == (3, M, 4, 6, 12)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("mode,var", [("fixed", 4.0), ("random", 9.0)])
def test_gaussian_k_schedule_identical(mode, var):
    np.testing.assert_array_equal(
        gaussian_k_schedule(7, 5, var, 6, mode=mode, seed=2),
        j_k_schedule(7, 5, var, 6, mode=mode, seed=2))


def _params(kind, rng):
    if kind == "lr":
        shapes = {"w": (60, 10), "b": (10,)}
    else:
        shapes = {"w1": (60, 64), "b1": (64,), "w2": (64, 10), "b2": (10,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("kind,p", [("lr", 640), ("mlp", 4608)])
def test_flat_spec_and_ravel_match(kind, p):
    rng = np.random.default_rng(0)
    tree = _params(kind, rng)
    jspec = jflat.make_flat_spec(jax.tree.map(jax.numpy.asarray, tree))
    spec = tflat.make_flat_spec(params_from_numpy(tree, "cpu"))
    assert (spec.n, spec.p) == (jspec.n, jspec.p) and spec.p == p
    assert spec.offsets == jspec.offsets
    assert spec.shapes == jspec.shapes
    buf = tflat.ravel(spec, params_from_numpy(tree, "cpu"))
    jbuf = jflat.ravel(jspec, jax.tree.map(jax.numpy.asarray, tree))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert not buf[spec.n:].any()                 # the pad tail is zero
    # client rows, and the way back
    rows = {k: np.stack([v, 2 * v]) for k, v in tree.items()}
    mat = tflat.ravel(spec, params_from_numpy(rows, "cpu"), client_dims=1)
    np.testing.assert_array_equal(
        mat.numpy(), np.asarray(jflat.ravel(
            jspec, jax.tree.map(jax.numpy.asarray, rows), client_dims=1)))
    back = tflat.unravel(spec, buf)
    views = tflat.view_tree(spec, buf)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
        np.testing.assert_array_equal(views[k].numpy(), v)
        assert views[k].data_ptr() != back[k].data_ptr()
