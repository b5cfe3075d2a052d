"""The port's LM stack (``repro_torch.models``) against the JAX reference
(``repro.models``) on the CPU, at reduced size, with the reference's
weights carried across (``convert.lm_params_from_numpy``).

Six reduced configurations: llama3-8b forced to GQA (``reduced`` gives
MHA), gemma-2b (MQA, GeGLU, tied embeddings, head dim 64 here),
qwen1.5-32b (QKV bias), deepseek-v2-lite (MLA with kv_lora 32, dn 64, dr
16, dv 64; MoE of 4 experts, top-2, one shared), granite-moe (MoE of 4
experts, top-2, GQA, tied embeddings) and gemma3-12b (a local layer of
window 16, then a global one).  Everything is float32; logits, caches
and the MoE aux loss agree to TOL (the same float32 operations, summed in
other orders by XLA and by PyTorch; measured ≲ 2e-6 at these sizes)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import ARCHS, get_arch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.convert import (lm_caches_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
CONFIGS = {"llama3-8b": dict(n_heads=4, n_kv_heads=2, head_dim=32),
           "gemma-2b": {}, "qwen1.5-32b": {}, "deepseek-v2-lite-16b": {},
           "granite-moe-1b-a400m": {}, "gemma3-12b": {}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    name = request.param
    cfg = dataclasses.replace(reduced(get_arch(name)), **CONFIGS[name])
    tcfg = dataclasses.replace(treduced(tregistry.get_arch(name)),
                               **CONFIGS[name])
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, params, lm_params_from_numpy(_np(params), "cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_match_reference(name):
    want = get_arch(name)
    got = tregistry.get_arch(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert dataclasses.asdict(treduced(got)) == dataclasses.asdict(
        reduced(want))
    assert got.layer_pattern() == want.layer_pattern()


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="available"):
        tregistry.get_arch("gpt-5")


# -- layers ------------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32)
    scale = 0.1 * rng.standard_normal(64, np.float32)   # 1 + scale gain
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            1e-6), want, 1e-6)


def test_layer_norm_matches():
    rng = np.random.default_rng(1)
    x, s, b = (rng.standard_normal(sh, np.float32)
               for sh in ((3, 32), (32,), (32,)))
    want = jlayers.layer_norm(*(jnp.asarray(a) for a in (x, s, b)))
    _close(tlayers.layer_norm(*(torch.from_numpy(a) for a in (x, s, b))),
           want, 1e-6)


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu"])
def test_activation_matches(kind):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    _close(tlayers.activation(torch.from_numpy(x), kind),
           jlayers.activation(jnp.asarray(x), kind), 1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches(batched):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 32), np.float32)
    pos = (np.arange(7, dtype=np.int32)[None] + np.array([[0], [500]])
           if batched else np.arange(7, dtype=np.int32))
    want = jlayers.apply_rope(
        jnp.asarray(x), jlayers.rope_angles(jnp.asarray(pos), 32, 5e5))
    got = tlayers.apply_rope(
        torch.from_numpy(x), tlayers.rope_angles(torch.from_numpy(pos), 32,
                                                 5e5))
    _close(got, want, 1e-5)


# -- the model ---------------------------------------------------------------

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


def test_forward_blocked_path_matches(model):
    """S = 40: the reference's q-block scan (its kernel needs S % 128 == 0)
    against the port's flash plain version."""
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, 40, 0)
    want, _, aux = M.forward(params, {"tokens": jnp.asarray(toks)}, cfg)
    got, caches, taux = TM.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                   tcfg)
    assert caches is None
    assert (float(aux) == 0.0) == (cfg.moe is None)
    assert abs(float(taux) - float(aux)) <= TOL
    _close(got, want)


def test_forward_kernel_path_matches(model, monkeypatch):
    """S = 128 with the reference's Pallas kernel forced (interpret mode)."""
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "interpret")
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 1, 128, 1)
    want = M.forward(params, {"tokens": jnp.asarray(toks)}, cfg)[0]
    before = dict(fa_ops.launches)
    got = TM.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)[0]
    assert fa_ops.launches == before        # CPU tensors launch nothing
    _close(got, want)


def test_prefill_and_decode_match(model):
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, 21, 2)
    caches = M.init_caches(cfg, 2, 32, jnp.float32)
    tcaches = TM.init_caches(tcfg, 2, 32, torch.float32, "cpu")
    for c, tc in zip(_np(caches), tcaches):
        assert sorted(c) == sorted(tc)
        for k in c:
            np.testing.assert_array_equal(tc[k].numpy(), c[k])
    tcaches = lm_caches_from_numpy(_np(caches), "cpu")
    want, caches = M.serve_prefill(params, {"tokens": jnp.asarray(toks[:, :20])},
                                   cfg, caches=caches)
    got, tcaches = TM.serve_prefill(
        tparams, {"tokens": torch.from_numpy(toks[:, :20])}, tcfg,
        caches=tcaches)
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, want)
    offs = np.array([20, 20], np.int32)
    for step in range(2):
        for c, tc in zip(_np(caches), tcaches):
            assert sorted(tc) == sorted(c)
            for k in c:
                if k in ("pos", "idx"):
                    np.testing.assert_array_equal(tc[k].numpy(), c[k])
                else:                   # k, v; or MLA's ckv, krope
                    _close(tc[k], c[k])
        tok = toks[:, 20:21] if step == 0 else np.asarray(
            jnp.argmax(want[:, -1:], -1)).astype(np.int32)
        want, caches = M.serve_decode(params, {"tokens": jnp.asarray(tok)},
                                      caches, jnp.asarray(offs), cfg)
        got, tcaches = TM.serve_decode(
            tparams, {"tokens": torch.from_numpy(tok)}, tcaches,
            torch.from_numpy(offs), tcfg)
        _close(got, want)
        offs = offs + 1


def test_lm_loss_matches(model):
    cfg, tcfg, params, tparams = model
    toks = _tokens(cfg, 2, 24, 3)
    labels = _tokens(cfg, 2, 24, 4)
    want = M.lm_loss(params, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)}, cfg)
    got = TM.lm_loss(tparams, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels).long()},
                     tcfg)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_lm_loss_gradient_flows_on_cpu(model):
    """On the CPU the plain attention's backward (the route a CPU tensor
    takes through ``FlashAttentionFn``; the card's is the dq and dk/dv
    kernels) reaches every weight: each gets a gradient."""
    _, tcfg, _, tparams = model
    params = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    toks = torch.from_numpy(_tokens(tcfg, 1, 16, 5))
    TM.lm_loss(params, {"tokens": toks, "labels": toks.long()},
               tcfg).backward()
    grads = []
    tree_map(lambda t: grads.append(t.grad), params)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("name,what", [
    ("xlstm-125m", "xLSTM"), ("musicgen-medium", "audio"),
    ("qwen2-vl-2b", "vision")])
def test_unported_parts_raise(name, what):
    """The parts the port once refused (xLSTM stacks, the audio and vision
    front ends) init, make caches and run a forward (their parity with
    the reference: ``test_torch_xlstm.py``, ``test_torch_frontends.py``)."""
    cfg = treduced(tregistry.get_arch(name))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    caches = TM.init_caches(cfg, 1, 8, device="cpu")
    if what == "audio":
        batch = {"codes": torch.ones(1, cfg.n_codebooks, 4, dtype=torch.long)}
        shape = (1, 4, cfg.n_codebooks, cfg.vocab)
    elif what == "vision":
        batch = {"embeds": torch.ones(1, 4, cfg.d_model),
                 "positions": torch.arange(4).expand(1, 3, 4)}
        shape = (1, 4, cfg.vocab)
    else:
        batch = {"tokens": torch.ones(1, 4, dtype=torch.long)}
        shape = (1, 4, cfg.vocab)
    logits, new, aux = TM.forward(params, batch, cfg, caches=caches)
    assert logits.shape == shape and torch.isfinite(logits).all()
    assert len(new) == len(caches) and float(aux) == 0.0


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "gemma3-12b"])
def test_moe_mla_and_window_parts_run(name):
    """The parts the port once refused (MoE, MLA, sliding-window layers)
    run init, caches and a forward."""
    cfg = treduced(tregistry.get_arch(name))
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    caches = TM.init_caches(cfg, 1, 8, device="cpu")
    logits, new, aux = TM.forward(params, {"tokens": torch.ones(1, 4,
                                                                dtype=torch.long)},
                                  cfg, caches=caches)
    assert logits.shape == (1, 4, cfg.vocab) and torch.isfinite(logits).all()
    assert len(new) == len(caches) and bool(aux > 0) == (cfg.moe is not None)


def test_mla_attention_inits():
    """MLA's weights without an MoE block beside them (the reference's
    ``init_attention`` branch): the latent down- and up-projections and a
    zero ``ckv_norm``."""
    from repro_torch.models import attention
    cfg = dataclasses.replace(
        treduced(tregistry.get_arch("deepseek-v2-lite-16b")), moe=None)
    m = cfg.mla
    p = attention.init_attention(torch.Generator(), cfg, torch.float32)
    H, dqk = cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (cfg.d_model, H * dqk),
        "w_kv_down": (cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim),
        "w_kv_up": (m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
        "wo": (H * m.v_head_dim, cfg.d_model),
        "ckv_norm": (m.kv_lora_rank,)}
    assert not p["ckv_norm"].any()


@pytest.mark.parametrize("logit_cap,window,is_global", [
    (30.0, 0, True), (5.0, 16, False), (5.0, 16, True), (0.0, 8, False)])
def test_blocked_and_decode_attention_match(logit_cap, window, is_global):
    """The plain-torch cores the flash kernel does not cover: soft-capped
    logits in flight, and decode against a cache with empty slots."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    pos = np.arange(40, dtype=np.int32)
    want = jattn.blocked_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), window=window,
        is_global=is_global, logit_cap=logit_cap, block_q=16)
    got = tattn.blocked_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos, pos)), window=window,
        is_global=is_global, logit_cap=logit_cap)
    _close(got, want, 1e-5)
    kv_pos = np.tile(pos, (2, 1))
    kv_pos[1, 30:] = -1                          # an empty tail in row 1
    q_pos = np.array([39, 29], np.int32)
    want = jattn.decode_attention(
        *(jnp.asarray(a) for a in (q[:, :1], k, v, q_pos, kv_pos)),
        window=window, is_global=is_global, logit_cap=logit_cap)
    got = tattn.decode_attention(
        *(torch.from_numpy(a) for a in (q[:, :1], k, v, q_pos, kv_pos)),
        window=window, is_global=is_global, logit_cap=logit_cap)
    _close(got, want, 1e-5)
