"""The port's Mamba2 block and the zamba2 hybrid stack
(``repro_torch.models.mamba2``, ``blocks``, ``model``) against the JAX
reference on the CPU, with the reference's weights carried across
(``convert.lm_params_from_numpy``).

The configuration is ``reduced(zamba2-2.7b, n_layers=4)``: d 128, 2 heads
of dim 64, SSM head dim 32, d_state 16, chunk 16, and a shared attention
block after every 2 Mamba2 layers — two groups, so the shared block runs
twice with weights it shares and caches it does not.  Everything is
float32.  Logits and cache leaves agree to TOL, the tolerance
tests/test_torch_lm.py holds the attention stacks to, and the loss to
1e-5 relative, as there: the same float32 operations, summed in other
orders by XLA and by PyTorch.  That noise starts in the first matrix
product (in_proj: 1.7e-6 on values up to 4.6) and reaches 3.7e-6 on
logits near zero, so a 2e-6 absolute floor would not hold; the SSD's own
share is 7e-7 relative (3e-5 on values up to 42)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import (lm_caches_from_numpy,  # noqa: E402
                                 lm_params_from_numpy, params_from_numpy)
from repro_torch.core import flat  # noqa: E402
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _ssd_fake_card import plain_card  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
LOSS_RTOL = 1e-5
# the reference's decode-against-forward tolerance
# (tests/test_models_smoke.py)
DECODE_TOL = 2e-3
STACKS = {"hybrid": {}, "ssm": dict(family="ssm", hybrid_attn_every=0)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(stack):
    cfg = dataclasses.replace(reduced(get_arch("zamba2-2.7b"), n_layers=4),
                              **STACKS[stack])
    tcfg = dataclasses.replace(
        treduced(tregistry.get_arch("zamba2-2.7b"), n_layers=4),
        **STACKS[stack])
    return cfg, tcfg


@pytest.fixture(scope="module", params=list(STACKS))
def model(request):
    cfg, tcfg = _cfgs(request.param)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, params, lm_params_from_numpy(_np(params), "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _caches_close(tcaches, caches):
    caches = _np(caches)
    assert len(tcaches) == len(caches)
    for tc, c in zip(tcaches, caches):
        assert sorted(tc) == sorted(c)
        for k in c:
            assert tuple(tc[k].shape) == c[k].shape, k
            if k in ("pos", "idx"):
                np.testing.assert_array_equal(tc[k].numpy(), c[k])
            else:
                _close(tc[k], c[k])


# -- the block ---------------------------------------------------------------

def test_mamba_block_matches():
    """One Mamba2 block: no cache (S = 32, two chunks), a prefill into an
    empty cache, then three single-token steps of the recurrence."""
    cfg, tcfg = _cfgs("hybrid")
    p = jmamba.init_mamba(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = params_from_numpy(_np(p), "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, none = jmamba.mamba(p, jnp.asarray(x), cfg)
    got, tnone = tmamba.mamba(tp, torch.from_numpy(x), tcfg)
    assert none is None and tnone is None
    _close(got, want)
    cache = jmamba.init_mamba_cache(cfg, 2, jnp.float32)
    tcache = tmamba.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    for k in cache:
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(cache[k]))
    want, cache = jmamba.mamba(p, jnp.asarray(x[:, :16]), cfg, cache)
    got, tcache = tmamba.mamba(tp, torch.from_numpy(x[:, :16]), tcfg, tcache)
    _close(got, want)
    for step in range(16, 19):
        _caches_close([tcache], [cache])
        xs = x[:, step:step + 1]
        want, cache = jmamba.mamba(p, jnp.asarray(xs), cfg, cache)
        got, tcache = tmamba.mamba(tp, torch.from_numpy(xs), tcfg, tcache)
        _close(got, want)


def test_init_mamba_has_the_reference_leaves():
    cfg, tcfg = _cfgs("hybrid")
    want = _np(jmamba.init_mamba(jax.random.PRNGKey(0), cfg, jnp.float32))
    got = tmamba.init_mamba(torch.Generator().manual_seed(0), tcfg,
                            torch.float32, lead=(3,))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == (3,) + want[k].shape, k
        assert got[k].numpy().dtype == want[k].dtype, k
    for k in ("D", "dt_bias", "norm", "conv_b"):
        np.testing.assert_array_equal(got[k][2].numpy(), want[k])
    # log(1..nh): torch's and XLA's float32 log may differ by an ulp
    np.testing.assert_allclose(got["A_log"][2].numpy(), want["A_log"],
                               rtol=2.0 ** -23, atol=0)


def test_causal_conv_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jmamba._causal_conv(*(jnp.asarray(a) for a in (x, w, b)))
    got = tmamba._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.is_contiguous()
    _close(got, want)


def test_softplus_is_jax_softplus():
    v = np.linspace(-40, 40, 801, dtype=np.float32)
    _close(tmamba._softplus(torch.from_numpy(v)),
           jax.nn.softplus(jnp.asarray(v)), 1e-6)


# -- the stack ---------------------------------------------------------------

def test_init_params_has_the_reference_tree(model):
    cfg, tcfg, params, _ = model
    got = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    want = _np(params)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype, path
    assert ("shared_attn" in got) == (cfg.hybrid_attn_every > 0)


@pytest.mark.parametrize("S", [32, 12])
def test_forward_matches(model, S):
    """S = 32: two chunks of 16; S = 12: one ragged chunk."""
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, S, S)
    want, _, aux = M.forward(params, {"tokens": jnp.asarray(toks)}, cfg)
    before = dict(ssd_ops.launches)
    got, caches, taux = TM.forward(tparams,
                                   {"tokens": torch.from_numpy(toks)}, tcfg)
    assert ssd_ops.launches == before       # CPU tensors launch nothing
    assert caches is None and float(taux) == float(aux) == 0.0
    _close(got, want)


def test_lm_loss_matches(model):
    cfg, tcfg, params, tparams = model
    toks, labels = _tokens(cfg, 2, 32, 3), _tokens(cfg, 2, 32, 4)
    want = M.lm_loss(params, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)}, cfg)
    got = TM.lm_loss(tparams, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels).long()},
                     tcfg)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


def test_lm_loss_gradient_flows_on_cpu(model):
    """On the CPU the plain SSD is differentiable: every weight gets a
    gradient."""
    _, tcfg, _, tparams = model
    params = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    toks = torch.from_numpy(_tokens(tcfg, 1, 16, 5))
    TM.lm_loss(params, {"tokens": toks, "labels": toks.long()},
               tcfg).backward()
    grads = []
    tree_map(lambda t: grads.append(t.grad), params)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_prefill_and_decode_match(model):
    """serve_prefill of 32 tokens (two chunks), then 8 greedy serve_decode
    steps: logits and every cache leaf against the reference's."""
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, 32, 6)
    caches = M.init_caches(cfg, 2, 48, jnp.float32)
    tcaches = TM.init_caches(tcfg, 2, 48, torch.float32, "cpu")
    for c, tc in zip(_np(caches), tcaches):
        assert sorted(c) == sorted(tc)
        for k in c:
            np.testing.assert_array_equal(tc[k].numpy(), c[k])
    tcaches = lm_caches_from_numpy(_np(caches), "cpu")
    want, caches = M.serve_prefill(params, {"tokens": jnp.asarray(toks)},
                                   cfg, caches=caches)
    got, tcaches = TM.serve_prefill(
        tparams, {"tokens": torch.from_numpy(toks)}, tcfg, caches=tcaches)
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, want)
    offs = np.array([32, 32], np.int32)
    for _ in range(8):
        _caches_close(tcaches, caches)
        tok = np.asarray(jnp.argmax(want[:, -1:], -1)).astype(np.int32)
        want, caches = M.serve_decode(params, {"tokens": jnp.asarray(tok)},
                                      caches, jnp.asarray(offs), cfg)
        got, tcaches = TM.serve_decode(
            tparams, {"tokens": torch.from_numpy(tok)}, tcaches,
            torch.from_numpy(offs), tcfg)
        _close(got, want)
        offs = offs + 1
    _caches_close(tcaches, caches)


def test_decode_matches_forward(model):
    """Prefill 16 tokens, then decode 16 token by token: the logits of the
    recurrence equal the full forward's (the reference's own check,
    tests/test_models_smoke.py, at its tolerance)."""
    _, tcfg, _, tparams = model
    full = torch.from_numpy(_tokens(tcfg, 2, 32, 7))
    logits_full = TM.forward(tparams, {"tokens": full}, tcfg)[0]
    caches = TM.init_caches(tcfg, 2, 32, torch.float32, "cpu")
    logits, caches = TM.serve_prefill(tparams, {"tokens": full[:, :16]},
                                      tcfg, caches=caches)
    _close(logits[:, -1], logits_full[:, 15], DECODE_TOL)
    for s in range(16, 32):
        logits, caches = TM.serve_decode(tparams, {"tokens": full[:, s:s + 1]},
                                         caches, s, tcfg)
        _close(logits[:, 0], logits_full[:, s], DECODE_TOL)


def test_flat_layout_round_trips_the_tree(model):
    """The flat layout's view table on the hybrid tree (``shared_attn``,
    the empty shared segment) and the Mamba2-only tree: the reference's
    leaf order, shapes and offsets, and ravel → unravel bit for bit."""
    _, _, params, tparams = model
    want = jflat.make_flat_spec(params)
    got = flat.make_flat_spec(tparams)
    assert (got.n, got.p) == (want.n, want.p)
    assert got.offsets == want.offsets and got.shapes == want.shapes
    assert got.paths == tuple(
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(params)[0])
    buf = flat.ravel(got, tparams)
    np.testing.assert_array_equal(buf.numpy(),
                                  np.asarray(jflat.ravel(want, params)))
    back = flat.unravel(got, buf)
    assert isinstance(back["segments"], list)
    assert sorted(back) == sorted(tparams)
    if "shared_attn" in tparams:
        assert back["segments"][1] == {}
    for (pa, a), (pb, b) in zip(flat._leaves(back), flat._leaves(tparams)):
        assert pa == pb and torch.equal(a, b)


# -- what the port does and refuses -----------------------------------------

def test_zamba2_hybrid_runs():
    """zamba2-2.7b no longer raises (it did until the Mamba2 port): its
    default reduced form (one group) initialises, makes caches and runs,
    through the attention and SSD wrappers."""
    cfg = treduced(tregistry.get_arch("zamba2-2.7b"))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    caches = TM.init_caches(cfg, 1, 8, device="cpu")
    assert [sorted(c) for c in caches] == [["conv", "ssm"],
                                           ["idx", "k", "pos", "v"]]
    assert params["segments"][1] == {} and "shared_attn" in params
    toks = torch.zeros(1, 4, dtype=torch.long)
    logits = TM.forward(params, {"tokens": toks}, cfg)[0]
    assert logits.shape == (1, 4, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_short_prefill_raises():
    """A prefill shorter than d_conv − 1 tokens fills only part of the
    convolution cache; the reference fails on the next decode step
    (ROADMAP C10), the port refuses the prefill by name.  Three tokens work."""
    _, tcfg = _cfgs("hybrid")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    caches = TM.init_caches(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="d_conv − 1 = 3"):
        TM.serve_prefill(params, {"tokens": torch.zeros(1, 2,
                                                        dtype=torch.long)},
                         tcfg, caches=caches)
    _, caches = TM.serve_prefill(
        params, {"tokens": torch.zeros(1, 3, dtype=torch.long)}, tcfg,
        caches=caches)
    logits, _ = TM.serve_decode(
        params, {"tokens": torch.zeros(1, 1, dtype=torch.long)}, caches, 3,
        tcfg)
    assert torch.isfinite(logits).all()


def _client_batch(tcfg, m, b, S, seed):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, tcfg.vocab, (m, b, S + 1)))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def test_training_on_the_card_launches_once_per_layer_for_all_clients(
        monkeypatch):
    """The flat round's vmapped local step (``flat_value_and_grad`` of the
    hybrid ``lm_loss``, two groups) on a fake card: each Mamba2 layer
    launches the SSD forward once, keeping its states, and each of the four
    backward kernels once, for both clients together — x folded to
    (M·b, S, heads, P), A to (M·b, heads) at batch stride heads — and never
    the CPU route; losses and gradients equal the CPU route's."""
    _, tcfg = _cfgs("hybrid")
    m, b, S = 2, 2, 32                     # two SSD chunks of 16
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    spec = flat.make_flat_spec(params)
    rows = flat.ravel(spec, params)[None].repeat(m, 1)
    rows[1, :spec.n] += 1e-3 * torch.randn(spec.n, generator=torch.Generator(
        ).manual_seed(1))
    batch = _client_batch(tcfg, m, b, S, 3)
    vag = flat.flat_value_and_grad(
        spec, lambda p, bt: TM.lm_loss(p, bt, tcfg))
    want = vag(rows, batch)
    seen = plain_card(monkeypatch)
    got = vag(rows, batch)
    heads = tcfg.ssm.expand * tcfg.d_model // tcfg.ssm.head_dim
    x_shape = (m * b, S, heads, tcfg.ssm.head_dim)
    layers = 4
    for name in ("ssd_scan", "ssd_bwd_dstate", "ssd_bwd_chunk"):
        # ssd_bwd_dstate's dy is shaped as x
        assert [(ln.x, ln.a, ln.a_stride) for ln in seen[name]] == [
            (x_shape, (m * b, heads), heads)] * layers
    assert ssd_ops.launches == {name: layers for name in ssd_ops.launches}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_unvmapped_training_on_the_card_shares_one_A(monkeypatch):
    """A plain ``lm_loss`` backward (no vmap) on the fake card hands the
    kernels the model's one A (heads,) at batch stride 0, and dA comes
    back (heads,): its gradient reaches A_log."""
    _, tcfg = _cfgs("ssm")
    params = tree_map(lambda t: t.requires_grad_(True),
                      TM.init_params(torch.Generator().manual_seed(0), tcfg))
    seen = plain_card(monkeypatch)
    batch = {k: v[0] for k, v in _client_batch(tcfg, 1, 2, 32, 4).items()}
    TM.lm_loss(params, batch, tcfg).backward()
    heads = tcfg.ssm.expand * tcfg.d_model // tcfg.ssm.head_dim
    assert {ln.a for ln in seen["ssd_bwd_chunk"]} == {(heads,)}
    assert {ln.a_stride for ln in seen["ssd_scan"]} == {0}
    assert ssd_ops.launches["ssd_bwd_reduce"] == tcfg.n_layers
    a_logs = [t for path, t in flat._leaves(params) if "A_log" in path]
    assert len(a_logs) and all(t.grad is not None
                               and bool(t.grad.abs().sum() > 0)
                               for t in a_logs)


def test_inference_on_the_card_keeps_no_states(monkeypatch):
    """A prefill under inference mode on the fake card launches the SSD
    forward once per Mamba2 layer, keeping no states, and no backward
    kernel."""
    _, tcfg = _cfgs("hybrid")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    caches = TM.init_caches(tcfg, 1, 24, device="cpu")
    calls = []
    plain = ssd_ops.ssd_scan

    def counted(*args, **kw):
        calls.append(kw.get("states", False))
        return plain(*args, **kw)

    plain_card(monkeypatch)
    monkeypatch.setattr(ssd_ops, "ssd_scan", counted)
    with torch.inference_mode():
        TM.serve_prefill(params, {"tokens": torch.zeros(1, 16,
                                                        dtype=torch.long)},
                         tcfg, caches=caches)
    assert calls == [False] * 4
    assert ssd_ops.launches["ssd_scan"] == 4
    assert not any(ssd_ops.launches[k] for k in ssd_ops.BWD_KERNELS)


def test_prefill_calls_each_kernel_wrapper_once_per_layer(monkeypatch):
    """One prefill of the two-group stack calls the SSD wrapper once per
    Mamba2 layer and the attention wrapper once per shared-block
    application; a decode step calls neither (on the card, each call is
    one launch)."""
    _, tcfg = _cfgs("hybrid")
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    caches = TM.init_caches(tcfg, 1, 24, device="cpu")
    calls = {"ssd": 0, "attn": 0}
    ssd_scan, flash_attention = (tmamba.ssd_scan_diff,
                                 fa_ops.flash_attention_diff)

    def count_ssd(*a, **kw):
        calls["ssd"] += 1
        return ssd_scan(*a, **kw)

    def count_attn(*a, **kw):
        calls["attn"] += 1
        return flash_attention(*a, **kw)

    monkeypatch.setattr(tmamba, "ssd_scan_diff", count_ssd)
    monkeypatch.setattr(fa_ops, "flash_attention_diff", count_attn)
    with torch.inference_mode():
        _, caches = TM.serve_prefill(
            params, {"tokens": torch.zeros(1, 16, dtype=torch.long)}, tcfg,
            caches=caches)
        assert calls == {"ssd": 4, "attn": 2}
        TM.serve_decode(params, {"tokens": torch.zeros(1, 1,
                                                       dtype=torch.long)},
                        caches, 16, tcfg)
    assert calls == {"ssd": 4, "attn": 2}
