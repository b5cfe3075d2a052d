"""The port's ``optim`` (``sgd_init`` / ``sgd_update`` / ``apply_updates``,
``adamw_init`` / ``adamw_update``) against the reference's ``repro.optim``
on the CPU: ``tests/test_substrates.py``'s three optimiser cases run
through both packages, then several steps on a nested tree drawn with
numpy (float32 and bfloat16 leaves, weight decay, momentum).

Tolerances.  The same float32 operations in the same order; XLA may
contract ``a · x + b`` into one fused multiply-add where PyTorch rounds
twice, so float32 results agree to TOL relative (an ulp or two per step)
and bfloat16 ones to one bfloat16 ulp (BF16_TOL relative)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.core.tree_util import tree_leaves, tree_map  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL, BF16_TOL = 1e-6, 2.0 ** -8


def _both(tree):
    """A numpy tree as (jax tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            tree_map(lambda a: torch.from_numpy(np.array(a)), tree))


def _close(got, want, tol=TOL):
    want = jax.tree_util.tree_leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{w.dtype}"
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol * float(np.abs(
                                       np.asarray(w, np.float32)).max()))


# -- tests/test_substrates.py's cases, through both packages ------------------

def test_sgd_matches_manual():
    jp, tp = _both({"w": np.array([1.0, 2.0], np.float32)})
    jg, tg = _both({"w": np.array([0.5, -1.0], np.float32)})
    ju, _ = jopt.sgd_update(jg, jopt.sgd_init(jp), jp, lr=0.1)
    tu, st = topt.sgd_update(tg, topt.sgd_init(tp), tp, lr=0.1)
    assert st.momentum is None
    new = topt.apply_updates(tp, tu)
    _close(new, jopt.apply_updates(jp, ju))
    np.testing.assert_allclose(new["w"].numpy(), [0.95, 2.1])


def test_sgd_momentum_accumulates():
    jp, tp = _both({"w": np.zeros(2, np.float32)})
    jg, tg = _both({"w": np.ones(2, np.float32)})
    jst, tst = jopt.sgd_init(jp, momentum=0.9), topt.sgd_init(tp,
                                                              momentum=0.9)
    for want in (-1.0, -1.9):
        ju, jst = jopt.sgd_update(jg, jst, jp, lr=1.0, momentum=0.9)
        tu, tst = topt.sgd_update(tg, tst, tp, lr=1.0, momentum=0.9)
        _close(tu, ju)
        _close(tst.momentum, jst.momentum)
        np.testing.assert_allclose(tu["w"].numpy(), want, rtol=TOL)


def test_adamw_first_step_is_lr_sized():
    jp, tp = _both({"w": np.array([0.0], np.float32)})
    jg, tg = _both({"w": np.array([0.3], np.float32)})
    ju, jst = jopt.adamw_update(jg, jopt.adamw_init(jp), jp, lr=0.01)
    tu, tst = topt.adamw_update(tg, topt.adamw_init(tp), tp, lr=0.01)
    _close(tu, ju)
    assert tst.step.dtype == torch.int32 and int(tst.step) == int(jst.step)
    np.testing.assert_allclose(tu["w"].numpy(), -0.01, rtol=1e-4)


# -- several steps on a nested tree -------------------------------------------

def _tree(rng, dtype):
    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"a": leaf(3, 5), "w": {"b": leaf(7), "c": [leaf(2, 2, 3),
                                                      leaf(4)]}}
    if dtype == "bfloat16":
        import ml_dtypes
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    return tree


def _torch_tree(tree):
    """bfloat16 numpy leaves through float32 (numpy has no bfloat16 that
    ``torch.from_numpy`` reads)."""
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32))
                    .to(torch.bfloat16 if a.dtype.name == "bfloat16"
                        else torch.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,weight_decay", [(0.0, 0.0), (0.9, 0.0),
                                                   (0.9, 0.01)])
def test_sgd_steps_match_reference(dtype, momentum, weight_decay):
    rng = np.random.default_rng(0)
    p0 = _tree(rng, dtype)
    jp, tp = jax.tree.map(jnp.asarray, p0), _torch_tree(p0)
    jst, tst = jopt.sgd_init(jp, momentum), topt.sgd_init(tp, momentum)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    for _ in range(4):
        g = _tree(rng, dtype)
        kw = dict(lr=0.05, momentum=momentum, weight_decay=weight_decay)
        ju, jst = jopt.sgd_update(jax.tree.map(jnp.asarray, g), jst, jp,
                                  **kw)
        tu, tst = topt.sgd_update(_torch_tree(g), tst, tp, **kw)
        _close(tu, ju, tol)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _close(tp, jp, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_steps_match_reference(dtype, weight_decay):
    """Five steps: float32 moments and an int32 step in both packages,
    updates in the parameters' dtype."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng, dtype)
    jp, tp = jax.tree.map(jnp.asarray, p0), _torch_tree(p0)
    jst, tst = jopt.adamw_init(jp), topt.adamw_init(tp)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    for _ in range(5):
        g = _tree(rng, dtype)
        kw = dict(lr=0.01, weight_decay=weight_decay)
        ju, jst = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jst, jp,
                                    **kw)
        tu, tst = topt.adamw_update(_torch_tree(g), tst, tp, **kw)
        _close(tu, ju, tol)
        _close(tst.mu, jst.mu)
        _close(tst.nu, jst.nu)
        assert int(tst.step) == int(jst.step)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _close(tp, jp, tol)
