"""The port's MoE (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU, with the reference's weights carried
across (``convert.params_from_numpy``) and inputs drawn with numpy.

Two routing shapes: 4 experts, top-2, capacity factor E (nothing drops;
``tests/test_moe.py``'s configuration, also held against its dense
every-expert reference), and deepseek-v2-lite's own routing — 64
experts, top-6, 2 shared, capacity factor 1.25 — at narrow widths, at T =
4 tokens (capacity 1: a decode tick of 4 slots) and T = 64 (capacity
8).  ``configs.base.reduced`` would cut to 4 experts and change the
capacity arithmetic, so these configurations keep E and k.

Expert ids, the kept mask and the aux loss are equal; float32 weights and
outputs agree within TOL (the same float32 operations, summed in other
orders by XLA and by PyTorch); bfloat16 outputs within BF16_TOL of the
output's largest entry (a bfloat16 rounding of the same float32 sums)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_moe import dense_moe_ref  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
BF16_TOL = 2.0 ** -7


def _small(E=4, top_k=2, cap=None, n_shared=0, d=32, f=16):
    """tests/test_moe.py's configuration (capacity factor E: nothing
    drops), in both packages."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
              n_kv_heads=2, d_ff=f, vocab=64)
    moe_kw = dict(n_experts=E, top_k=top_k, d_ff=f, n_shared_experts=n_shared,
                  capacity_factor=cap if cap is not None else float(E))
    return (ModelConfig(**kw, moe=MoEConfig(**moe_kw)),
            tbase.ModelConfig(**kw, moe=tbase.MoEConfig(**moe_kw)))


def _deepseek_routing(d=64, f=32):
    """deepseek-v2-lite's MoE (64 experts, top-6, 2 shared, capacity
    factor 1.25, aux coefficient 0.01) at width d, expert width f."""
    def cut(cfg):
        return dataclasses.replace(cfg, d_model=d, d_ff=f,
                                   moe=dataclasses.replace(cfg.moe, d_ff=f))
    return (cut(get_arch("deepseek-v2-lite-16b")),
            cut(tregistry.get_arch("deepseek-v2-lite-16b")))


ROUTINGS = {"e4_top2": _small, "deepseek": _deepseek_routing}


def _params(cfg, seed=0, dtype=jnp.float32):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg, dtype)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _x(T, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((1, T, d)).astype(
        dtype)


def _jmoe(p, x, cfg):
    """The reference's ``moe``, compiled once (faster than op by op)."""
    return jax.jit(lambda p, x: jmoe.moe(p, x, cfg))(p, jnp.asarray(x))


def _kept(ids: np.ndarray, C: int) -> np.ndarray:
    """The kept mask in flat (token, choice) order, written out: each
    expert keeps its first C assignments in flat order."""
    seen: dict[int, int] = {}
    keep = []
    for e in ids.reshape(-1).tolist():
        seen[e] = seen.get(e, 0) + 1
        keep.append(seen[e] <= C)
    return np.asarray(keep)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("routing,T", [("e4_top2", 16), ("deepseek", 4),
                                       ("deepseek", 64)])
def test_route_matches(routing, T):
    cfg, tcfg = ROUTINGS[routing]()
    p, tp = _params(cfg)
    x = _x(T, cfg.d_model, 1)[0]
    w, ids, aux = jax.jit(jmoe.route, static_argnums=2)(
        p["router"], jnp.asarray(x), cfg.moe.top_k)
    tw, tids, taux = tmoe.route(tp["router"], torch.from_numpy(x),
                                tcfg.moe.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    _close(tw, w)
    assert abs(float(taux) - float(aux)) <= TOL * abs(float(aux))
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("routing,T,C", [("e4_top2", 16, 32),
                                         ("deepseek", 4, 1),
                                         ("deepseek", 64, 8),
                                         ("deepseek", 26, 3)])
def test_capacity_and_kept_mask(routing, T, C):
    """``capacity`` is the reference's ``max(1, round(T·k/E·cf))`` with
    Python's round (26·6/64·1.25 = 3.05 → 3; 4·6/64·1.25 = 0.47 → 1),
    and the dispatch keeps each expert's first C assignments in flat
    order — the reference's sorted-position rule, written out."""
    cfg, tcfg = ROUTINGS[routing]()
    assert tmoe.capacity(T, tcfg) == C == int(max(1, round(
        T * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor)))
    _, tp = _params(cfg)
    _, ids, _ = tmoe.route(tp["router"], torch.from_numpy(
        _x(T, cfg.d_model, 2)[0]), tcfg.moe.top_k)
    E = tcfg.moe.n_experts
    order, dst = tmoe.dispatch(ids, C, E)
    keep = dst < E * C
    want = _kept(ids.numpy(), C)
    np.testing.assert_array_equal(keep.numpy(), want[order.numpy()])
    assert (dst[~keep] == E * C).all()
    assert dst[keep].unique().numel() == int(keep.sum())   # no row twice
    # a kept assignment's row lies in its own expert's block of C rows
    np.testing.assert_array_equal(
        (dst[keep] // C).numpy(), ids.reshape(-1)[order][keep].numpy())


def test_capacity_rounds_halves_to_even():
    """Python's round: 2.5 → 2 and 3.5 → 4 (T·k/E·cf with E 4, k 1)."""
    _, tcfg = _small(E=4, top_k=1, cap=1.0)
    assert [tmoe.capacity(T, tcfg) for T in (10, 14, 2, 1)] == [2, 4, 1, 1]


@pytest.mark.parametrize("routing,T", [("e4_top2", 16), ("deepseek", 4),
                                       ("deepseek", 64)])
def test_moe_matches(routing, T):
    """y and the aux loss against the reference's ``moe``, with the
    shared experts (deepseek) and with capacity drops (deepseek at T = 4
    and 64)."""
    cfg, tcfg = ROUTINGS[routing]()
    p, tp = _params(cfg, seed=3)
    x = _x(T, cfg.d_model, 4)
    want, aux = _jmoe(p, x, cfg)
    got, taux = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    assert abs(float(taux) - float(aux)) <= TOL * max(abs(float(aux)), 1e-6)
    if routing == "deepseek":
        _, ids, _ = tmoe.route(tp["router"], torch.from_numpy(x[0]),
                               tcfg.moe.top_k)
        kept = _kept(ids.numpy(), tmoe.capacity(T, tcfg))
        assert not kept.all()          # the capacity binds at both T


def test_moe_matches_dense_reference_without_drops():
    """tests/test_moe.py's dense every-expert reference, at capacity E."""
    cfg, tcfg = _small()
    p, tp = _params(cfg, seed=5)
    x = _x(16, cfg.d_model, 6).reshape(2, 8, cfg.d_model)
    got, _ = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    want = dense_moe_ref(p, jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_dropped_tokens_read_zeros():
    """With no shared expert, a token whose every choice is dropped gets
    y = 0 exactly (the sink row), as in the reference."""
    cfg, tcfg = _small(E=4, top_k=2, cap=0.25)
    p, tp = _params(cfg, seed=7)
    x = _x(32, cfg.d_model, 8)
    got, _ = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    want, _ = _jmoe(p, x, cfg)
    _close(got, want)
    _, ids, _ = tmoe.route(tp["router"], torch.from_numpy(x[0]), 2)
    kept = _kept(ids.numpy(), tmoe.capacity(32, tcfg)).reshape(32, 2)
    dropped = ~kept.any(axis=1)
    assert dropped.any()
    assert not got[0, torch.from_numpy(dropped)].any()


def test_moe_matches_in_bfloat16():
    """A bfloat16 block: the router stays float32 (logits and routing
    equal), the experts run in bfloat16."""
    cfg, tcfg = _deepseek_routing()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    p, tp = _params(cfg, seed=9, dtype=jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w_in"].dtype == torch.bfloat16
    x = _x(64, cfg.d_model, 10).astype(jnp.bfloat16)
    want, aux = _jmoe(p, x, cfg)
    got, taux = tmoe.moe(tp, params_from_numpy(x, "cpu"), tcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err
    assert abs(float(taux) - float(aux)) <= 1e-5 * abs(float(aux))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_moe_has_the_reference_tree(dtype):
    cfg, tcfg = _deepseek_routing()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0),
                                                  cfg, jdt))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, dtype,
                        lead=(3, 1))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        lambda t: t.float().numpy() if t.dtype == torch.bfloat16
        else t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == (3, 1) + w.shape, path
    assert got["router"].dtype == torch.float32
    assert got["w_in"].dtype == dtype and got["shared"]["w_in"].dtype == dtype
    # the experts' scales: N(0, 1/d) in, N(0, 1/f) out
    d, f = tcfg.d_model, tcfg.moe.d_ff
    assert abs(float(got["w_in"].float().std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(got["w_out"].float().std()) * f ** 0.5 - 1) < 0.05


def test_moe_gradients_flow_to_all_parts():
    _, tcfg = _small(n_shared=1)
    tp = tmoe.init_moe(torch.Generator().manual_seed(6), tcfg,
                       torch.float32)
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp,
                      is_leaf=lambda t: isinstance(t, torch.Tensor))
    x = torch.from_numpy(_x(16, tcfg.d_model, 7).reshape(2, 8, -1))
    y, aux = tmoe.moe(tp, x, tcfg)
    ((y ** 2).sum() + aux).backward()
    for name in ("router", "w_in", "w_gate", "w_out"):
        assert float(tp[name].grad.abs().max()) > 0, name
    assert float(tp["shared"]["w_in"].grad.abs().max()) > 0
