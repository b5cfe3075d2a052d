"""The paper's remaining models, partitions and closed forms in the port
against the JAX package on the CPU, from the same numpy-made inputs.

* ``cnn_*``: logits, loss, accuracy and per-client gradients (the flat
  layout's ``flat_value_and_grad`` under ``torch.func.vmap``) against
  ``jax.grad`` at the same parameters, rtol 1e-5 with an atol of 1e-6 at
  the outputs' unit scale: two 5×5 convolutions and two dense layers sum
  in other orders in XLA and in the CPU's convolution and BLAS kernels,
  float32 rounding only.
* ``quad_loss`` / ``quad_global_opt``: rtol 1e-5 (a 12-term dot; a 12×12
  solve in float32).
* ``lr_accuracy`` / ``mlp_accuracy`` / ``cnn_accuracy`` bit-equal at
  every count of correct samples (``jnp.mean``'s float32 sum × 1/n);
* ``lr_init`` equal; ``dirichlet_partition``, ``shard_partition`` and
  ``quadratic_clients`` bit-equal (numpy only, the same draws); every
  ``core/theory.py`` function equal to the last bit (the same numpy float64
  code).
* ``gaussian_classification`` / ``image_classification`` draw from a
  ``torch.Generator``, not ``jax.random``: their contract (shapes, dtypes,
  label range, template range, reproducible from the seed).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import theory as jtheory  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import flat, theory  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

CNN_TOL = dict(rtol=1e-5, atol=1e-6)
QUAD_TOL = dict(rtol=1e-5, atol=1e-6)
CNN_SHAPES = {"c1": (5, 5, 1, 10), "c2": (5, 5, 10, 20), "w1": (320, 50),
              "b1": (50,), "w2": (50, 10), "b2": (10,)}


def _cnn_params(seed=0):
    rng = np.random.default_rng(seed)
    scale = {"c1": 0.1, "c2": 0.1, "w1": (2 / 320) ** 0.5,
             "w2": (2 / 50) ** 0.5, "b1": 0.1, "b2": 0.1}
    return {k: (scale[k] * rng.standard_normal(s)).astype(np.float32)
            for k, s in CNN_SHAPES.items()}


def _images(rng, *lead):
    x = rng.random(lead + (28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, lead).astype(np.int32)
    return x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_logits_loss_and_accuracy_match_jax(seed):
    params = _cnn_params(seed)
    x, y = _images(np.random.default_rng(seed), 6)
    tp = convert.params_from_numpy(params, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(simple._cnn_logits(tp, tx).numpy(),
                               np.asarray(jsimple._cnn_logits(jp, x)),
                               **CNN_TOL)
    batch = {"x": x, "y": y}
    tbatch = {"x": tx, "y": ty}
    np.testing.assert_allclose(float(simple.cnn_loss(tp, tbatch)),
                               float(jsimple.cnn_loss(jp, batch)),
                               **CNN_TOL)
    assert float(simple.cnn_accuracy(tp, tbatch)) == float(
        jsimple.cnn_accuracy(jp, batch))


ACC_COUNTS_N = (3, 7, 610, 1000, 4000, 6000)
ACC_CHUNK = 2048                     # label rows per vmapped call


def _all_count_labels(n: int):
    """Label rows with c leading zeros and ones after them, for every
    c = 0 … n, in chunks of one shape (the last padded with c = n): against
    logits whose argmax is class 0 for every sample, a row has exactly c
    correct."""
    rows = min(n + 1, ACC_CHUNK)
    counts = np.arange(-(-(n + 1) // rows) * rows).clip(max=n)
    for c in counts.reshape(-1, rows):
        yield (np.arange(n)[None, :] >= c[:, None]).astype(np.int32)


def _argmax_zero_models(n: int):
    """(name, port accuracy, JAX accuracy, numpy params, x): each model's
    logits put class 0 first at every one of the n samples."""
    x2 = np.tile(np.float32([[1.0, 0.0]]), (n, 1))
    eye = np.eye(2, dtype=np.float32)
    zeros2 = np.zeros(2, np.float32)
    cnn = {k: np.zeros(s, np.float32) for k, s in CNN_SHAPES.items()}
    cnn["b2"][0] = 1.0
    return [("lr", simple.lr_accuracy, jsimple.lr_accuracy,
             {"w": eye, "b": zeros2}, x2),
            ("mlp", simple.mlp_accuracy, jsimple.mlp_accuracy,
             {"w1": eye, "b1": zeros2, "w2": eye, "b2": zeros2}, x2),
            ("cnn", simple.cnn_accuracy, jsimple.cnn_accuracy, cnn,
             np.zeros((n, 28, 28, 1), np.float32))]


@pytest.mark.parametrize("n", ACC_COUNTS_N)
def test_accuracies_bit_equal_to_jax_at_every_count(n):
    """The port's accuracies round as ``jnp.mean`` does (its float32 sum
    times float32 1/n), not as ``sum / n``, which is one ulp off at about
    half of the counts (the Table 1 lr non-IID row crosses 0.78 on it)."""
    for name, port_acc, jax_acc, params, x in _argmax_zero_models(n):
        tp = convert.params_from_numpy(params, "cpu")
        jp = jax.tree.map(jnp.asarray, params)
        tx = torch.from_numpy(x)
        port = torch.vmap(lambda y: port_acc(tp, {"x": tx, "y": y}))
        ref = jax.jit(jax.vmap(lambda y: jax_acc(jp, {"x": x, "y": y})))
        for ys in _all_count_labels(n):
            got = port(torch.from_numpy(ys)).numpy()
            want = np.asarray(ref(ys))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32), err_msg=name)
        # the eager calls the benchmarks make, at a count that splits the
        # two roundings (n = 4000: 3120 correct)
        c = n * 39 // 50
        y = (np.arange(n) >= c).astype(np.int32)
        got = np.float32(port_acc(tp, {"x": tx, "y": torch.from_numpy(y)}))
        want = np.float32(jax_acc(jp, {"x": x, "y": y}))
        assert got.view(np.int32) == want.view(np.int32), name


def test_cnn_params_keep_the_reference_flat_layout():
    """HWIO kernels in the reference's shapes: the same leaf order and
    P = 21810 → 21888, so a JAX flat buffer means the same in the port."""
    spec = flat.make_flat_spec(convert.params_from_numpy(_cnn_params(),
                                                         "cpu"))
    assert (spec.n, spec.p) == (21810, 21888)
    assert spec.paths == (("b1",), ("b2",), ("c1",), ("c2",), ("w1",),
                          ("w2",))
    init = simple.cnn_init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == CNN_SHAPES


def test_cnn_per_client_grads_match_jax_grad():
    """Per-client gradients of the CNN through the flat layout's vmapped
    value-and-grad, against ``jax.grad`` client by client."""
    m = 3
    params = [_cnn_params(s) for s in range(m)]
    x, y = _images(np.random.default_rng(7), m, 5)
    spec = flat.make_flat_spec(convert.params_from_numpy(params[0], "cpu"))
    rows = torch.stack([flat.ravel(spec, convert.params_from_numpy(p, "cpu"))
                        for p in params])
    losses, grads = flat.flat_value_and_grad(spec, simple.cnn_loss)(
        rows, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    jvag = jax.value_and_grad(jsimple.cnn_loss)
    for i in range(m):
        loss, g = jvag(jax.tree.map(jnp.asarray, params[i]),
                       {"x": x[i], "y": y[i]})
        np.testing.assert_allclose(float(losses[i]), float(loss), **CNN_TOL)
        want = flat.ravel(spec, convert.params_from_numpy(
            jax.tree.map(np.asarray, g), "cpu"))
        np.testing.assert_allclose(grads[i].numpy(), want.numpy(),
                                   **CNN_TOL)
    assert not grads[:, spec.n:].any()


def test_quad_loss_and_global_opt_match_jax():
    rng = np.random.default_rng(3)
    As, bs = jsynthetic.quadratic_clients(jax.random.PRNGKey(0), 5, 12)
    x = rng.standard_normal(12).astype(np.float32)
    for i in range(5):
        batch = {"A": As[i], "b": bs[i], "c0": np.float32(0.25)}
        np.testing.assert_allclose(
            float(simple.quad_loss({"x": torch.from_numpy(x)},
                                   convert.params_from_numpy(batch, "cpu"))),
            float(jsimple.quad_loss({"x": jnp.asarray(x)}, batch)),
            **QUAD_TOL)
    w = (rng.random(5) + 0.5).astype(np.float32)
    w /= w.sum()
    np.testing.assert_allclose(
        simple.quad_global_opt(torch.from_numpy(As), torch.from_numpy(bs),
                               torch.from_numpy(w)).numpy(),
        np.asarray(jsimple.quad_global_opt(As, bs, w)), **QUAD_TOL)


def test_lr_init_matches_jax():
    got = simple.lr_init(torch.Generator().manual_seed(0), 60, 10)
    want = jsimple.lr_init(jax.random.PRNGKey(0), 60, 10)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("m,alpha,seed", [(10, 0.3, 0), (7, 1.0, 3),
                                          (40, 0.05, 1)])
def test_dirichlet_partition_bit_equal(m, alpha, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 600)
    got = partition.dirichlet_partition(labels, m, alpha, seed)
    want = jpartition.dirichlet_partition(labels, m, alpha, seed)
    assert len(got) == len(want) == m
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_dirichlet_partition_degenerate_draw_gives_one_sample():
    """A client the Dirichlet draw leaves empty gets one random sample, in
    both packages the same one."""
    labels = np.zeros(3, np.int64)              # one class, 3 samples
    got = partition.dirichlet_partition(labels, 8, 0.05, seed=2)
    want = jpartition.dirichlet_partition(labels, 8, 0.05, seed=2)
    singles = [p for p in got if p.size == 1]
    assert len(singles) >= 8 - 3                # some client was empty
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,cpc,seed", [(10, 2, 0), (6, 5, 4), (25, 3, 9)])
def test_shard_partition_bit_equal(m, cpc, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 500)
    got = partition.shard_partition(labels, m, cpc, seed)
    want = jpartition.shard_partition(labels, m, cpc, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(got).tolist()) == list(range(500))


@pytest.mark.parametrize("key,m,d,hetero,cond", [
    (0, 8, 12, 1.5, 4.0), (1, 4, 6, 0.0, 10.0), (5, 3, 16, 1.0, 4.0)])
def test_quadratic_clients_bit_equal(key, m, d, hetero, cond):
    jkey = jax.random.PRNGKey(key)
    seed = int(jax.random.randint(jkey, (), 0, 2 ** 31 - 1))
    As, bs = synthetic.quadratic_clients(seed, m, d, hetero, cond)
    jAs, jbs = jsynthetic.quadratic_clients(jkey, m, d, hetero, cond)
    assert As.dtype == bs.dtype == np.float32
    np.testing.assert_array_equal(As, jAs)
    np.testing.assert_array_equal(bs, jbs)


def test_theory_matches_reference():
    As, bs = synthetic.quadratic_clients(31327077, 8, 12, hetero=1.5)
    w = np.full(8, 1 / 8, np.float32)
    ks = np.array([1, 1, 2, 2, 4, 4, 8, 20], np.int32)
    x_star = theory.global_optimum(As, bs, w)
    np.testing.assert_array_equal(x_star,
                                  jtheory.global_optimum(As, bs, w))
    np.testing.assert_array_equal(theory.local_optimum(As[2], bs[2]),
                                  jtheory.local_optimum(As[2], bs[2]))
    np.testing.assert_array_equal(
        theory.fedavg_fixed_point(As, bs, w, ks, 0.02),
        jtheory.fedavg_fixed_point(As, bs, w, ks, 0.02))
    assert theory.objective_inconsistency_rhs(As, bs, w, ks, x_star) == \
        jtheory.objective_inconsistency_rhs(As, bs, w, ks, x_star)
    x = x_star + 0.1
    assert theory.suboptimality(As, bs, w, x, x_star) == \
        jtheory.suboptimality(As, bs, w, x, x_star)


def test_gaussian_classification_contract():
    data = synthetic.gaussian_classification(
        torch.Generator().manual_seed(0), 500, d=12, n_classes=7)
    again = synthetic.gaussian_classification(
        torch.Generator().manual_seed(0), 500, d=12, n_classes=7)
    assert data.x.shape == (500, 12) and data.x.dtype == torch.float32
    assert data.y.shape == (500,) and data.y.dtype == torch.int32
    assert data.x.device.type == data.y.device.type == "cpu"
    assert int(data.y.min()) >= 0 and int(data.y.max()) < 7
    assert len(torch.unique(data.y)) == 7
    assert torch.equal(data.x, again.x) and torch.equal(data.y, again.y)


def test_image_classification_contract():
    gen = torch.Generator().manual_seed(1)
    data = synthetic.image_classification(gen, 300, n_classes=10, side=28,
                                          noise=0.0)
    assert data.x.shape == (300, 28, 28, 1) and data.x.dtype == torch.float32
    assert data.y.dtype == torch.int32
    assert int(data.y.min()) >= 0 and int(data.y.max()) < 10
    # without noise every image is its class template, in (0, 1)
    assert float(data.x.min()) > 0.0 and float(data.x.max()) < 1.0
    for c in torch.unique(data.y):
        rows = data.x[data.y == c]
        assert torch.equal(rows, rows[:1].expand_as(rows))
