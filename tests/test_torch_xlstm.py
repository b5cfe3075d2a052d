"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
reference (``repro.models.xlstm``) on the CPU, float32, with the
reference's weights carried across (``convert.params_from_numpy``).

Tolerances: TOL = 2e-5 between the two packages (the same float32
operations summed in other orders); RECURRENCE_TOL = 2e-4 between the
parallel form and the recurrence, two algorithms (the reference's own
test, ``tests/test_ssm_equivalence.py``, holds them to the same)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
RECURRENCE_TOL = 2e-4
# the reference's parallel form, compiled once per shape (its eager scan
# compiles op by op, seconds a call)
j_parallel = jax.jit(jx._mlstm_parallel, static_argnames="block_q")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def naive_mlstm(q, k, v, log_i, log_f):
    """Literal stabilized mLSTM recurrence (a copy of
    ``tests/test_ssm_equivalence.py``'s)."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    C = jnp.zeros((B, H, hd, hd), jnp.float32)
    n = jnp.zeros((B, H, hd), jnp.float32)
    m = jnp.full((B, H), -jnp.inf, jnp.float32)
    outs = []
    for t in range(S):
        li, lf = log_i[:, t], log_f[:, t]
        m_new = jnp.maximum(lf + m, li)
        i_s = jnp.exp(li - m_new)
        f_s = jnp.exp(lf + m - m_new)
        k0 = k[:, t].astype(jnp.float32) * scale
        v0 = v[:, t].astype(jnp.float32)
        q0 = q[:, t].astype(jnp.float32)
        C = (f_s[..., None, None] * C
             + i_s[..., None, None] * jnp.einsum("bhd,bhe->bhde", k0, v0))
        n = f_s[..., None] * n + i_s[..., None] * k0
        num = jnp.einsum("bhd,bhde->bhe", q0, C)
        den = jnp.maximum(jnp.abs(jnp.einsum("bhd,bhd->bh", n, q0)),
                          jnp.exp(-m_new))
        outs.append(num / den[..., None])
        m = m_new
    return jnp.stack(outs, axis=1)


def _gates(S, seed, B=2, H=2, hd=16, forget=None):
    """q, k, v standard normal; log_i N(0, 1); log_f log_sigmoid(N(0, 1) +
    2), or the constant ``forget``."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd), np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((B, S, H), np.float32)
    if forget is None:
        log_f = np.asarray(jax.nn.log_sigmoid(
            rng.standard_normal((B, S, H), np.float32) + 2.0))
    else:
        log_f = np.full((B, S, H), forget, np.float32)
    return q, k, v, log_i, log_f


def _port_recurrence(q, k, v, log_i, log_f):
    """The port's decode step (``_mlstm_step``) run over the sequence from
    the empty state."""
    B, S, H, hd = q.shape
    state = (torch.zeros(B, H, hd, hd), torch.zeros(B, H, hd),
             torch.full((B, H), -torch.inf))
    outs = []
    for t in range(S):
        state, h = tx._mlstm_step(state, _t(q[:, t]),
                                  _t(k[:, t]) * hd ** -0.5, _t(v[:, t]),
                                  _t(log_i[:, t]), _t(log_f[:, t]))
        outs.append(h)
    return torch.stack(outs, dim=1)


# -- the parallel form -------------------------------------------------------

@pytest.mark.parametrize("S,block_q", [(48, 16), (40, 16), (37, 7),
                                       (33, 256)])
def test_mlstm_parallel_matches_reference(S, block_q):
    """Several query blocks, a short last one (the reference's pad path),
    and one block covering everything."""
    q, k, v, log_i, log_f = _gates(S, S)
    want = j_parallel(*(jnp.asarray(a) for a in
                                (q, k, v, log_i, log_f)), block_q=block_q)
    got = tx._mlstm_parallel(*(_t(a) for a in (q, k, v, log_i, log_f)),
                             block_q=block_q)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)


def test_mlstm_parallel_matches_recurrence():
    q, k, v, log_i, log_f = _gates(48, 1)
    want = naive_mlstm(*(jnp.asarray(a) for a in (q, k, v, log_i, log_f)))
    got = tx._mlstm_parallel(*(_t(a) for a in (q, k, v, log_i, log_f)),
                             block_q=16)
    _close(got, want, RECURRENCE_TOL)
    # the port's own decode step is the same recurrence
    _close(_port_recurrence(q, k, v, log_i, log_f), want, TOL)


def test_c21_port_finite_where_the_reference_gives_nan():
    """ROADMAP C21: at log_f = −10 the reference's exp(a_s − amax_q)
    overflows above the diagonal by S = 32 and its mask, multiplied in
    after, makes inf · 0 = NaN; the port masks the exponent first and
    matches the recurrence."""
    q, k, v, log_i, log_f = _gates(32, 2, forget=-10.0)
    args = [jnp.asarray(a) for a in (q, k, v, log_i, log_f)]
    ref = np.asarray(j_parallel(*args, block_q=16))
    assert np.isnan(ref).any()
    want = naive_mlstm(*args)
    assert np.isfinite(np.asarray(want)).all()
    got = tx._mlstm_parallel(*(_t(a) for a in (q, k, v, log_i, log_f)),
                             block_q=16)
    assert torch.isfinite(got).all()
    _close(got, want, RECURRENCE_TOL)
    # wherever the reference is finite the two agree
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[finite], ref[finite], rtol=TOL,
                               atol=TOL)


# -- the blocks ---------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    cfg = reduced(get_arch("xlstm-125m"))
    tcfg = treduced(tregistry.get_arch("xlstm-125m"))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    mp, sp = jax.jit(lambda a, b: (jx.init_mlstm(a, cfg, jnp.float32),
                                   jx.init_slstm(b, cfg, jnp.float32)))(
        *keys)
    return (cfg, tcfg, mp, params_from_numpy(_np(mp), "cpu"), sp,
            params_from_numpy(_np(sp), "cpu"))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), np.float32)


def _cache_close(got: dict, want: dict, tol=TOL):
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_without_cache_matches(blocks, kind):
    cfg, tcfg, mp, tmp, sp, tsp = blocks
    x = _x(cfg, 2, 19, 3)
    jfn, tfn, p, tp = ((jx.mlstm, tx.mlstm, mp, tmp) if kind == "mlstm"
                       else (jx.slstm, tx.slstm, sp, tsp))
    want, wc = jax.jit(lambda p, x: jfn(p, x, cfg))(p, jnp.asarray(x))
    got, gc = tfn(tp, _t(x), tcfg)
    assert wc is None and gc is None
    _close(got, want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match(blocks, kind):
    """A prefill (mLSTM's second branch: the conv tail and the closed-form
    C / n / m) then three one-token steps (the recurrence, its conv in
    float32 on the window), the caches equal key by key after each."""
    cfg, tcfg, mp, tmp, sp, tsp = blocks
    jfn, tfn, p, tp, jinit, tinit = (
        (jx.mlstm, tx.mlstm, mp, tmp, jx.init_mlstm_cache,
         tx.init_mlstm_cache) if kind == "mlstm" else
        (jx.slstm, tx.slstm, sp, tsp, jx.init_slstm_cache,
         tx.init_slstm_cache))
    cache = jinit(cfg, 2, jnp.float32)
    tcache = tinit(tcfg, 2, torch.float32, "cpu")
    for key in cache:           # the empty caches equal (m −inf for mLSTM)
        np.testing.assert_array_equal(tcache[key].numpy(), cache[key])
    x = _x(cfg, 2, 14, 4)
    ref = jax.jit(lambda p, x, c: jfn(p, x, cfg, c))
    want, cache = ref(p, jnp.asarray(x[:, :11]), cache)
    got, tcache = tfn(tp, _t(x[:, :11]), tcfg, tcache)
    _close(got, want)
    _cache_close(tcache, cache)
    for t in range(11, 14):
        want, cache = ref(p, jnp.asarray(x[:, t:t + 1]), cache)
        got, tcache = tfn(tp, _t(x[:, t:t + 1]), tcfg, tcache)
        _close(got, want)
        _cache_close(tcache, cache)


def test_decode_continues_the_no_cache_forward(blocks):
    """The mLSTM prefill's state, stepped on, gives the no-cache forward's
    outputs for the later tokens (the parallel form and the recurrence)."""
    cfg, tcfg, _, tmp, _, _ = blocks
    x = _t(_x(cfg, 1, 12, 5))
    full, _ = tx.mlstm(tmp, x, tcfg)
    cache = tx.init_mlstm_cache(tcfg, 1, torch.float32, "cpu")
    _, cache = tx.mlstm(tmp, x[:, :9], tcfg, cache)
    for t in range(9, 12):
        y, cache = tx.mlstm(tmp, x[:, t:t + 1], tcfg, cache)
        _close(y, full[:, t:t + 1].detach(), RECURRENCE_TOL)


def test_short_prefill_is_refused(blocks):
    """A 2-token prefill leaves a conv cache of 2 < conv_dim − 1 = 3 rows:
    the reference's next decode step fails on the shapes; the port
    refuses the prefill."""
    cfg, tcfg, mp, tmp, _, _ = blocks
    x = _x(cfg, 1, 3, 6)
    ref = jax.jit(lambda p, x, c: jx.mlstm(p, x, cfg, c))
    _, cache = ref(mp, jnp.asarray(x[:, :2]),
                   jx.init_mlstm_cache(cfg, 1, jnp.float32))
    assert cache["conv"].shape[1] == 2
    with pytest.raises(ValueError, match="does not match"):
        ref(mp, jnp.asarray(x[:, 2:]), cache)
    with pytest.raises(ValueError, match="conv_dim − 1 = 3"):
        tx.mlstm(tmp, _t(x[:, :2]), tcfg,
                 tx.init_mlstm_cache(tcfg, 1, torch.float32, "cpu"))


def test_bf16_init_keeps_the_reference_dtypes():
    """A bfloat16 model's leaves and caches in the reference's dtypes: the
    gate weights and biases and every recurrent state float32."""
    cfg = dataclasses.replace(reduced(get_arch("xlstm-125m")),
                              dtype="bfloat16")
    tcfg = dataclasses.replace(treduced(tregistry.get_arch("xlstm-125m")),
                               dtype="bfloat16")
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: M.init_params(jax.random.PRNGKey(0), cfg)))[0]
    got = jax.tree_util.tree_flatten_with_path(
        TM.init_params(torch.Generator().manual_seed(0), tcfg),
        is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    f32 = set()
    for (path, g), (_, w) in zip(got, want):
        assert str(g.dtype) == f"torch.{w.dtype}", path
        assert tuple(g.shape) == w.shape, path
        if w.dtype == jnp.float32:
            f32.add(path[-1].key)
    assert f32 == {"w_gates", "b_gates", "W", "R", "b"}
    caches = M.init_caches(cfg, 2, 8, jnp.bfloat16)
    tcaches = TM.init_caches(tcfg, 2, 8, device="cpu")
    for c, tc in zip(_np(caches), tcaches):
        for key in c:
            assert str(tc[key].dtype).split(".")[-1] == str(c[key].dtype)
            np.testing.assert_array_equal(tc[key].float().numpy(),
                                          np.asarray(c[key], np.float32))
    assert str(tcaches[0]["conv"].dtype) == "torch.bfloat16"


def test_b_gates_and_sLSTM_bias_are_the_references(blocks):
    _, _, mp, tmp, sp, tsp = blocks
    for key, p, tp in (("b_gates", mp, tmp), ("b", sp, tsp)):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(p[key]))
    got = tx.init_mlstm(torch.Generator(), treduced(
        tregistry.get_arch("xlstm-125m")), torch.float32)
    np.testing.assert_array_equal(got["b_gates"].numpy(),
                                  np.asarray(mp["b_gates"]))


# -- C22: a chunked prefill restarts every mLSTM layer ------------------------

def test_c22_chunked_prefill_loses_the_mlstm_context_alike():
    """ROADMAP C22: a second multi-token call after a prefill takes the
    prefill branch again, which reads neither the conv cache nor C / n /
    m: each mLSTM layer restarts from empty while the sLSTM layers carry
    on.  Both packages lose the same context: their logits and caches
    agree, and the mLSTM caches equal a fresh prefill of the second chunk
    alone."""
    cfg = reduced(get_arch("xlstm-125m"))
    tcfg = treduced(tregistry.get_arch("xlstm-125m"))
    params = jax.jit(lambda k: M.init_params(k, cfg))(jax.random.PRNGKey(1))
    tparams = lm_params_from_numpy(_np(params), "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 14)).astype(
        np.int32)
    first, second = toks[:, :8], toks[:, 8:]
    caches = M.init_caches(cfg, 2, 32, jnp.float32)
    _, caches = jax.jit(lambda p, b, c: M.serve_prefill(p, b, cfg, caches=c))(
        params, {"tokens": jnp.asarray(first)}, caches)
    want, caches = jax.jit(lambda p, b, c: M.serve_decode(p, b, c, 8, cfg))(
        params, {"tokens": jnp.asarray(second)}, caches)
    tcaches = TM.init_caches(tcfg, 2, 32, device="cpu")
    _, tcaches = TM.serve_prefill(tparams, {"tokens": _t(first)}, tcfg,
                                  caches=tcaches)
    got, tcaches = TM.serve_decode(tparams, {"tokens": _t(second)}, tcaches,
                                   8, tcfg)
    _close(got, want)
    for c, tc in zip(_np(caches), tcaches):
        _cache_close(tc, c)
    fresh = TM.serve_prefill(tparams, {"tokens": _t(second)}, tcfg,
                             caches=TM.init_caches(tcfg, 2, 32,
                                                   device="cpu"))[1]
    for key in ("conv", "C", "n", "m"):        # the mLSTM segment: lost
        torch.testing.assert_close(tcaches[0][key], fresh[0][key])
    assert not torch.allclose(tcaches[1]["c"], fresh[1]["c"])   # sLSTM: kept
    # the first chunk is what was lost: a whole prefill differs
    whole = TM.serve_prefill(tparams, {"tokens": _t(toks)}, tcfg,
                             caches=TM.init_caches(tcfg, 2, 32,
                                                   device="cpu"))[0]
    assert (whole[:, -1] - got[:, -1]).abs().max() > 1e-3
