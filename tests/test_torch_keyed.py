"""The port's numpy threefry (``repro_torch.fed.keyed``) against
``jax.random`` on the CPU.

* ``prng_key``, ``fold_in`` (one key and vectorised over ids) and
  ``uniform`` (scalar shape included) bit for bit over a grid of seeds,
  rounds, tags and ids — the chains ``fold_in(fold_in(fold_in(PRNGKey(s),
  t), tag), i)`` the failure scenarios draw from;
* ``normal`` within ``keyed.NORMAL_MAX_ULP`` float32 ulp of
  ``jax.random.normal`` (the same erfinv polynomial; numpy's float32
  ``log1p`` is not XLA's), and prefix-invariant: the first n draws of a
  longer request are a length-n request's;
* ``jax_threefry_partitionable`` is on: the port draws the partitionable
  counter's stream, and a jax that changed the default would put the
  reference on another stream.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.fed import keyed  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

SEEDS = (0, 5, 0x5CE7A510, 0x5CE7A510 ^ 0x0BAD5EED, 2 ** 31 - 5)
ROUNDS = (0, 3, 17, 1000)
TAGS = (0, 1, 2)
IDS = (0, 5, 99, 99_999)


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_uniform_bit_equal(seed):
    jk, nk = jax.random.PRNGKey(seed), keyed.prng_key(seed)
    assert np.array_equal(np.asarray(jk), nk)
    for t in ROUNDS:
        for tag in TAGS:
            jt = jax.random.fold_in(jax.random.fold_in(jk, t), tag)
            nt = keyed.fold_in(keyed.fold_in(nk, t), tag)
            assert np.array_equal(np.asarray(jt), nt)
            # one key per id, as the scenarios' per-client draws
            jv = jax.vmap(lambda i, k=jt: jax.random.fold_in(k, i))(
                jnp.asarray(IDS, jnp.int32))
            nv = keyed.fold_in(nt, np.asarray(IDS))
            assert np.array_equal(np.asarray(jv), nv)
            ju = jax.vmap(lambda k: jax.random.uniform(k, (2,)))(jv)
            nu = keyed.uniform(nv, (2,))
            assert nu.dtype == np.float32
            assert np.array_equal(np.asarray(ju).view(np.uint32),
                                  nu.view(np.uint32))
            # the scalar draw (spike's per-round event)
            assert np.asarray(jax.random.uniform(jt)).view(np.uint32) \
                == keyed.uniform(nt).view(np.uint32)


def test_uniform_multidimensional_shape_is_row_major():
    jk = jax.random.PRNGKey(11)
    ju = np.asarray(jax.random.uniform(jk, (3, 4, 5)))
    nu = keyed.uniform(keyed.prng_key(11), (3, 4, 5))
    assert nu.shape == (3, 4, 5)
    assert np.array_equal(ju.view(np.uint32), nu.view(np.uint32))


@pytest.mark.parametrize("seed", (0, 7, 0x5CE7A510))
def test_normal_within_ulp_and_prefix_invariant(seed):
    worst = 0
    for t in range(12):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        nk = keyed.fold_in(keyed.prng_key(seed), t)
        jn = np.asarray(jax.random.normal(jk, (4608,)))
        nn = keyed.normal(nk, (4608,))
        assert nn.dtype == np.float32 and np.isfinite(nn).all()
        worst = max(worst, int(_ulp(jn, nn).max()))
        # a padded row's first n draws are the unpadded row's
        assert np.array_equal(keyed.normal(nk, (610,)), nn[:610])
    assert worst <= keyed.NORMAL_MAX_ULP, worst
