"""The flat layout on LM parameter trees: ``core/flat.py`` walks lists and
tuples as well as dicts, in ``jax.tree_util`` order, so the LM tree —
``params["segments"]`` is a list of stacked block dicts — enters the flat
round.  (Before, ``make_flat_spec`` treated the list as one leaf and
raised ``AttributeError: 'list' object has no attribute 'shape'``.)

Against the reference's ``repro.core.flat.make_flat_spec`` on the same
weights: the same ``n``, ``p``, leaf order (key paths), shapes and
offsets; ``ravel`` → ``unravel`` round-trips bit for bit; and
``flat_value_and_grad`` of reduced gemma-2b's ``lm_loss`` (one vmapped
pass over all clients) equals a per-client ``torch.autograd.grad`` loop
to float32 rounding of the loss's reductions (GRAD_TOL)."""
import dataclasses
import functools
import gc

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

CONFIGS = {"llama3-8b": dict(n_heads=4, n_kv_heads=2, head_dim=32),
           "gemma-2b": {}, "qwen1.5-32b": {}, "granite-moe-1b-a400m": {},
           "deepseek-v2-lite-16b": {}, "gemma3-12b": {}, "xlstm-125m": {}}
GRAD_TOL = 1e-6


def _configs(name):
    cfg = dataclasses.replace(
        jreduced(jget_arch(name), n_layers=2, d_model=64, vocab=256),
        **CONFIGS[name])
    tcfg = dataclasses.replace(
        reduced(get_arch(name), n_layers=2, d_model=64, vocab=256),
        **CONFIGS[name])
    return cfg, tcfg


def _jax_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_spec_matches_reference(name):
    cfg, _ = _configs(name)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    want = jflat.make_flat_spec(params)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = flat.make_flat_spec(tparams)
    assert isinstance(tparams["segments"], list)
    assert (got.n, got.p) == (want.n, want.p)
    assert got.offsets == want.offsets and got.sizes == want.sizes
    assert got.shapes == want.shapes
    assert got.dtype == torch.float32
    assert got.paths == tuple(_jax_path(p) for p, _ in
                              jax.tree_util.tree_flatten_with_path(params)[0])
    # ravel → unravel round-trips; the buffer is the reference's
    buf = flat.ravel(got, tparams)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jflat.ravel(want, params)))
    back = flat.unravel(got, buf)
    assert isinstance(back["segments"], list)
    for (pa, a), (pb, b) in zip(flat._leaves(back), flat._leaves(tparams)):
        assert pa == pb and torch.equal(a, b)
    views = flat.view_tree(got, buf)
    assert views["embed"].data_ptr() == buf.data_ptr() + \
        got.offsets[got.paths.index(("embed",))] * 4


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "xlstm-125m"])
def test_bf16_spec_keeps_float32_leaves(name):
    """A bfloat16 model over a float32 master: the MoE router and xLSTM's
    gate weights, biases and sLSTM leaves stay float32 leaves in the view
    table, as in the reference's, and their views read the master's
    float32 values bit for bit."""
    cfg, _ = _configs(name)
    params = JM.init_params(jax.random.PRNGKey(0),
                            dataclasses.replace(cfg, dtype="bfloat16"))
    want = jflat.make_flat_spec(params, master_dtype="float32")
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = flat.make_flat_spec(tparams, master_dtype="float32")
    assert got.dtype == torch.float32
    assert [str(d).replace("torch.", "") for d in got.dtypes] \
        == [str(d) for d in want.dtypes]
    assert torch.float32 in got.dtypes and torch.bfloat16 in got.dtypes
    assert got.offsets == want.offsets and (got.n, got.p) == (want.n, want.p)
    buf = flat.ravel(got, tparams)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jflat.ravel(want, params)))
    for (path, v), (_, t) in zip(flat._leaves(flat.view_tree(got, buf)),
                                 flat._leaves(tparams)):
        assert v.dtype == t.dtype and torch.equal(v, t), path


def test_lists_and_tuples_are_containers():
    """Mixed containers flatten in jax order and rebuild with their types;
    client-stacked rows too."""
    tree = {"b": (torch.ones(3), [torch.zeros(2, 2), {"z": torch.arange(
        4.0), "a": torch.full((1,), 7.0)}]), "a": [torch.ones(5)]}
    spec = flat.make_flat_spec(tree)
    jtree = jax.tree.map(lambda t: np.asarray(t), tree,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jtree)
    assert spec.paths == tuple(_jax_path(p) for p, _ in leaves)
    assert spec.shapes == tuple(lv.shape for _, lv in leaves)
    assert spec.n == 5 + 3 + 4 + 1 + 4 and spec.p == flat.LANES
    rows = tree_map(lambda t: torch.stack([t, 2 * t]), tree)
    buf = flat.ravel(spec, rows, client_dims=1)
    back = flat.unravel(spec, buf, client_dims=1)
    assert isinstance(back["b"], tuple) and isinstance(back["b"][1], list)
    assert isinstance(back["a"], list)
    for (_, x), (_, y) in zip(flat._leaves(back), flat._leaves(rows)):
        assert torch.equal(x, y)
    assert not buf[:, spec.n:].any()


def test_flat_value_and_grad_of_lm_equals_per_client_loop():
    _, tcfg = _configs("gemma-2b")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    spec = flat.make_flat_spec(params)
    base = flat.ravel(spec, params)
    M = 3
    rows = torch.stack([base * (1.0 + 0.05 * i) for i in range(M)])
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (M, 2, 17)
                                         ).astype(np.int32))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    loss = functools.partial(TM.lm_loss, cfg=tcfg)
    calls = []
    real = fa_ops.flash_attention_bwd

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    fa_ops.flash_attention_bwd = counted
    try:
        losses, grads = flat.flat_value_and_grad(spec, lambda p, b: loss(
            p, b))(rows, batch)
    finally:
        fa_ops.flash_attention_bwd = real
    # one backward per layer for all clients, the client axis folded in B
    assert calls == [(M * 2, 16, tcfg.n_heads, tcfg.resolved_head_dim)] \
        * tcfg.n_layers
    assert grads.shape == (M, spec.p) and not grads[:, spec.n:].any()
    for i in range(M):
        tree = tree_map(lambda t: t.requires_grad_(),
                        flat.unravel(spec, rows[i]))
        li = loss(tree, {k: v[i] for k, v in batch.items()})
        gi = torch.autograd.grad(li, [t for _, t in flat._leaves(tree)])
        want = torch.cat([g.reshape(-1) for g in gi])
        np.testing.assert_allclose(float(losses[i]), float(li.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(grads[i, :spec.n].numpy(), want.numpy(),
                                   rtol=GRAD_TOL,
                                   atol=GRAD_TOL * float(want.abs().max()))


def test_local_step_leaves_no_cycle_holding_the_buffer():
    """The leaf views of a step's (M, P) buffer are freed by reference
    counting when the step ends, not left in a reference cycle for the
    garbage collector (at gemma-2b's width each stuck buffer is 6 GB)."""
    _, tcfg = _configs("gemma-2b")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    spec = flat.make_flat_spec(params)
    rows = torch.stack([flat.ravel(spec, params)] * 2)
    toks = torch.zeros((2, 1, 9), dtype=torch.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    loss = functools.partial(TM.lm_loss, cfg=tcfg)
    vag = flat.flat_value_and_grad(spec, lambda p, b: loss(p, b))
    gc.collect()
    gc.disable()
    flags = gc.get_debug()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        vag(rows, batch)
        flat.view_tree(spec, rows[0])
        gc.collect()
        stuck = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        gc.enable()
    assert stuck == []
