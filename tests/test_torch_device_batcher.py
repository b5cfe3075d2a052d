"""The port's device batchers against the JAX package on the CPU.

* ``keyed.randint`` (numpy) and ``keyed.t_randint`` (torch, from the
  split keys) equal ``jax.random.randint(key, shape, 0, n)`` bit for bit,
  n = 1 … 2³¹ − 1 (past 2¹⁶ the 32-bit wrap zeroes the multiplier),
  per-key bounds broadcast; ``t_threefry2x32`` / ``t_random_bits`` equal
  the numpy words.
* ``DeviceBatcher``'s ``row_indices``, ``sample_row``, ``sample``,
  ``sample_cohort`` and ``round_batches`` equal the reference's, and
  every row of ``sample_chunk`` / ``sample_rows`` equals its
  ``sample_row``; ``weights`` equal the reference's.
* ``DeviceLMBatcher`` over unequal token streams: the same.
* ``eval_metric`` equals the reference's on the same data and weights.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import DeviceBatcher as JDeviceBatcher  # noqa: E402
from repro.data import DeviceLMBatcher as JDeviceLMBatcher  # noqa: E402
from repro.data import eval_metric as j_eval_metric  # noqa: E402
from repro.data import fedprox_synthetic as j_synthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.data import (DeviceBatcher, DeviceLMBatcher,  # noqa: E402
                              eval_metric, fedprox_synthetic)
from repro_torch.fed import keyed  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

BOUNDS = [1, 2, 3, 611, 65535, 65536, 65537, 100_000, 2 ** 31 - 1]


def _key(seed, t, i):
    return (jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  t), i),
            keyed.fold_in(keyed.fold_in(keyed.prng_key(seed), t), i))


@pytest.mark.parametrize("n", BOUNDS)
@pytest.mark.parametrize("seed,t,i", [(0, 0, 0), (3, 7, 5), (2 ** 31 - 1,
                                                            1000, 99_999)])
def test_randint_bit_equal(seed, t, i, n):
    jkey, key = _key(seed, t, i)
    want = np.asarray(jax.random.randint(jkey, (4, 16), 0, n))
    got = keyed.randint(key, (4, 16), n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tgot = keyed.t_randint(
        torch.from_numpy(keyed.split(key).astype(np.int64)), (4, 16),
        torch.tensor(n))
    np.testing.assert_array_equal(tgot.numpy(), want)


def test_randint_per_key_bounds_broadcast():
    keys = keyed.fold_in(keyed.prng_key(5), np.arange(6))
    bounds = np.array([1, 7, 611, 65536, 65537, 100_000])
    got = keyed.randint(keys, (3, 2), bounds)
    tgot = keyed.t_randint(
        torch.from_numpy(keyed.split(keys).astype(np.int64)), (3, 2),
        torch.from_numpy(bounds))
    for j in range(6):
        want = np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.PRNGKey(5), j), (3, 2), 0,
            int(bounds[j])))
        np.testing.assert_array_equal(got[j], want)
        np.testing.assert_array_equal(tgot[j].numpy(), want)


def test_torch_words_equal_numpy_words():
    rng = np.random.default_rng(11)
    k0, k1, x0, x1 = (rng.integers(0, 2 ** 32, (3, 4), dtype=np.uint32)
                      for _ in range(4))
    want = keyed.threefry2x32(k0, k1, x0, x1)
    got = keyed.t_threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                                 for a in (k0, k1, x0, x1)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    keys = keyed.fold_in(keyed.prng_key(11), np.array([[0, 1, 2 ** 31 - 1],
                                                       [-1, 7, 123456]]))
    np.testing.assert_array_equal(
        keyed.t_random_bits(torch.from_numpy(keys.astype(np.int64)),
                            (5,)).numpy(),
        keyed.random_bits(keys, (5,)).astype(np.int64))


# ---------------------------------------------------------------------------
# the batchers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batchers():
    key = jax.random.PRNGKey(0)
    jdata, jparts = j_synthetic(key, 7, d=6, n_classes=3, n_per_client=9)
    data, parts = fedprox_synthetic(
        int(jax.random.randint(key, (), 0, 2 ** 31 - 1)), 7, d=6,
        n_classes=3, n_per_client=9)
    return (JDeviceBatcher(jdata, jparts, batch_size=4, seed=3),
            DeviceBatcher(data, parts, batch_size=4, seed=3, device="cpu"))


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_device_batcher_equals_reference(batchers):
    jb, tb = batchers
    np.testing.assert_array_equal(tb.weights.numpy(),
                                  np.asarray(jb.weights))
    for t, i in ((0, 0), (5, 2), (1000, 6)):
        np.testing.assert_array_equal(tb.row_indices(t, i, 3).numpy(),
                                      np.asarray(jb.row_indices(t, i, 3)))
        _equal(tb.sample_row(t, i, 3), jb.sample_row(t, i, 3))
    _equal(tb.sample(4, 3), jb.sample(jnp.int32(4), 3))
    _equal(tb.round_batches(9, 2), jb.round_batches(9, 2))
    cohort = np.array([6, 1, 1, 3], np.int32)
    _equal(tb.sample_cohort(4, cohort, 3),
           jb.sample_cohort(jnp.int32(4), jnp.asarray(cohort), 3))


def test_chunk_rows_equal_sample_row(batchers):
    _, tb = batchers
    cohorts = torch.tensor([[3, 1], [0, 6], [2, 2]])
    chunk = tb.sample_chunk([4, 5, 11], cohorts, 3)
    assert chunk["x"].shape == (3, 2, 3, 4, 6)
    full = tb.sample_chunk([4, 5], None, 3)
    assert full["y"].shape == (2, 7, 3, 4)
    for j, t in enumerate((4, 5, 11)):
        for c in range(2):
            _equal({k: v[j, c] for k, v in chunk.items()},
                   tb.sample_row(t, int(cohorts[j, c]), 3))
    _equal({k: v[1] for k, v in full.items()}, tb.sample(5, 3))
    waves = np.array([[0, 3], [2, 2]])
    ids = np.array([[5, 5], [1, 0]])
    rows = tb.sample_rows(waves, ids, 2)
    _equal({k: v[1, 0] for k, v in rows.items()}, tb.sample_row(2, 1, 2))


def test_device_lm_batcher_equals_reference():
    rng = np.random.default_rng(0)
    streams = [{"tokens": rng.integers(0, 50, (5 + 3 * i, 8)).astype(
                    np.int32),
                "labels": rng.integers(0, 50, (5 + 3 * i, 8)).astype(
                    np.int32)} for i in range(3)]
    jb = JDeviceLMBatcher([{k: jnp.asarray(v) for k, v in s.items()}
                           for s in streams], batch_size=2, seed=1)
    tb = DeviceLMBatcher(streams, batch_size=2, seed=1, device="cpu")
    np.testing.assert_array_equal(tb.weights.numpy(),
                                  np.asarray(jb.weights))
    _equal(tb.sample(2, 3), jb.sample(jnp.int32(2), 3))
    _equal(tb.sample_row(7, 2, 3), jb.sample_row(7, 2, 3))
    _equal(tb.sample_cohort(1, np.array([2, 0]), 3),
           jb.sample_cohort(jnp.int32(1), jnp.array([2, 0]), 3))
    chunk = tb.sample_chunk([3, 4], None, 2)
    _equal({k: v[1] for k, v in chunk.items()}, jb.sample(jnp.int32(4), 2))


def test_eval_metric_equals_reference():
    key = jax.random.PRNGKey(0)
    jdata, _ = j_synthetic(key, 4, d=6, n_classes=3, n_per_client=700)
    data, _ = fedprox_synthetic(
        int(jax.random.randint(key, (), 0, 2 ** 31 - 1)), 4, d=6,
        n_classes=3, n_per_client=700)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    want = j_eval_metric(jsimple.lr_accuracy,
                         {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jdata,
                         batch=1024)
    got = eval_metric(simple.lr_accuracy,
                      {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                      data, batch=1024)
    assert len(data) > 1024
    assert got == want
