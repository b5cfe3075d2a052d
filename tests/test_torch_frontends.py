"""The port's audio and vision front ends and its xLSTM stack
(``repro_torch.models.model``, ``layers.mrope_angles``) against the JAX
reference on the CPU, float32, at reduced size (xlstm-125m: one mLSTM and
one sLSTM layer; musicgen-medium: 4 codebooks; qwen2-vl-2b: M-RoPE), with
the reference's weights carried across (``convert.lm_params_from_numpy``)
and batches built as ``tests/test_models_smoke.py`` builds them, from a
numpy seed.  Also the ``serve_batched`` example twin against the
reference's loop.

Logits, the loss and the caches agree to TOL = 2e-5; gradients to
GRAD_TOL = 2e-5 of each leaf's largest entry (the same float32 operations
summed in other orders)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import (lm_caches_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
GRAD_TOL = 2e-5
ARCHS = ("xlstm-125m", "musicgen-medium", "qwen2-vl-2b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def make_batch(cfg, B=2, S=24, seed=0, labels=True) -> dict:
    """numpy inputs of ``cfg``'s front end (``test_models_smoke``'s)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        codes = rng.integers(0, cfg.vocab, (B, cfg.n_codebooks, S)).astype(
            np.int32)
        out = {"codes": codes}
    elif cfg.frontend == "vision":
        t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                             np.float32),
               "positions": np.stack([t, t % 4, t % 8], axis=1)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if labels:
        out["labels"] = (out["codes"] if "codes" in out else
                         rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    cfg = reduced(get_arch(name))
    tcfg = treduced(tregistry.get_arch(name))
    params = jax.jit(lambda k: M.init_params(k, cfg))(jax.random.PRNGKey(0))
    return cfg, tcfg, params, lm_params_from_numpy(_np(params), "cpu")


# -- M-RoPE -----------------------------------------------------------------

@pytest.mark.parametrize("dim,sections", [(128, (16, 24, 24)),
                                          (64, (16, 8, 8))])
def test_mrope_angles_match(dim, sections):
    """qwen2-vl's sections at head dim 128, and ``reduced``'s at 64."""
    if dim == 64:
        assert treduced(tregistry.get_arch("qwen2-vl-2b")).mrope_sections \
            == sections
    rng = np.random.default_rng(dim)
    pos = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    want = jlayers.mrope_angles(jnp.asarray(pos), dim, 1e6, sections)
    got = tlayers.mrope_angles(torch.from_numpy(pos), dim, 1e6, sections)
    assert got.shape == (2, 9, dim // 2)
    _close(got, want, 1e-6)


# -- the reduced models -------------------------------------------------------

def test_forward_matches(model):
    cfg, tcfg, params, tparams = model
    batch = make_batch(cfg, seed=1, labels=False)
    want, _, aux = jax.jit(lambda p, b: M.forward(p, b, cfg))(params,
                                                              _j(batch))
    got, caches, taux = TM.forward(tparams, _t(batch), tcfg)
    assert caches is None and float(taux) == float(aux) == 0.0
    assert got.shape == want.shape
    _close(got, want)


def test_lm_loss_and_gradients_match(model):
    """``lm_loss`` (audio: labels (B, K, S)) and its gradient with respect
    to every leaf against ``jax.value_and_grad``."""
    cfg, tcfg, params, tparams = model
    batch = make_batch(cfg, S=16, seed=2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: M.lm_loss(p, b, cfg)))(params, _j(batch))
    tp = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    tb = _t(batch)
    tb["labels"] = tb["labels"].long()
    tloss = TM.lm_loss(tp, tb, tcfg)
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= TOL * abs(float(loss))
    flat = jax.tree_util.tree_flatten_with_path(_np(grads))[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in tflat] == [p for p, _ in flat]
    for (path, t), (_, g) in zip(tflat, flat):
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(t.grad.numpy() / scale, g / scale,
                                   rtol=0, atol=GRAD_TOL, err_msg=str(path))


def _step_batch(cfg, tokens: np.ndarray, position: int) -> dict:
    """One decode position feeding back ``tokens``: codes (B, K, 1), a
    vision row's embedding of the token with all three M-RoPE ids at
    ``position``, or token ids (B, 1)."""
    if cfg.frontend == "audio":
        return {"codes": tokens.reshape(len(tokens), -1, 1)}
    if cfg.frontend == "vision":
        B = len(tokens)
        rng = np.random.default_rng(position)
        return {"embeds": rng.standard_normal((B, 1, cfg.d_model),
                                              np.float32),
                "positions": np.full((B, 3, 1), position, np.int32)}
    return {"tokens": tokens.reshape(-1, 1)}


def test_prefill_and_decode_match(model):
    """``serve_prefill`` then three ``serve_decode`` steps, each feeding
    back the reference's argmax, the caches equal key by key after each
    (mLSTM's conv / C / n / m, sLSTM's c / n / h / m, attention's k / v /
    pos / idx)."""
    cfg, tcfg, params, tparams = model
    S = 12
    prompt = make_batch(cfg, S=S, seed=3, labels=False)
    caches = M.init_caches(cfg, 2, S + 4, jnp.float32)
    tcaches = TM.init_caches(tcfg, 2, S + 4, torch.float32, "cpu")
    for c, tc in zip(_np(caches), tcaches):
        assert sorted(c) == sorted(tc)
        for key in c:
            np.testing.assert_array_equal(tc[key].numpy(), c[key])
    tcaches = lm_caches_from_numpy(_np(caches), "cpu")
    prefill = jax.jit(lambda p, b, c: M.serve_prefill(p, b, cfg, caches=c))
    decode = jax.jit(lambda p, b, c, o: M.serve_decode(p, b, c, o, cfg))
    want, caches = prefill(params, _j(prompt), caches)
    got, tcaches = TM.serve_prefill(tparams, _t(prompt), tcfg,
                                    caches=tcaches)
    _close(got, want)
    for step in range(3):
        for c, tc in zip(_np(caches), tcaches):
            assert sorted(tc) == sorted(c)
            for key in c:
                _close(tc[key], c[key])
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        batch = _step_batch(cfg, tok, S + 100 + step)
        want, caches = decode(params, _j(batch), caches, S + step)
        got, tcaches = TM.serve_decode(tparams, _t(batch), tcaches, S + step,
                                       tcfg)
        assert got.shape == want.shape
        _close(got, want)


# -- the serve_batched twin ---------------------------------------------------

def _reference_loop(params, prompts, cfg, new_tokens):
    """``examples/serve_batched.py``'s loop (its prefill, greedy argmax and
    decode calls, jitted as there)."""
    B, S0 = prompts.shape
    caches = M.init_caches(cfg, B, max_len=S0 + new_tokens,
                           dtype=jnp.float32)
    prefill = jax.jit(lambda p, b, c: M.serve_prefill(p, b, cfg, caches=c))
    decode = jax.jit(lambda p, b, c, off: M.serve_decode(p, b, c, off, cfg))
    logits, caches = prefill(params, {"tokens": jnp.asarray(prompts)},
                             caches)
    tok = jnp.argmax(logits[:, -1], axis=-1)
    out = [tok]
    for s in range(new_tokens - 1):
        logits, caches = decode(params, {"tokens": tok[:, None]}, caches,
                                S0 + s)
        tok = jnp.argmax(logits[:, 0], axis=-1)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], axis=1)


@pytest.mark.parametrize("name", ["llama3-8b", "xlstm-125m"])
def test_serve_batched_twin_matches_the_reference_loop(name):
    """The twin's ``generate`` on the reference's weights and prompts
    emits the reference loop's tokens."""
    cfg = reduced(get_arch(name))
    tcfg = treduced(tregistry.get_arch(name))
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: M.init_params(k, cfg))(key)
    prompts = np.asarray(jax.random.randint(key, (3, 10), 0, cfg.vocab),
                         np.int32)
    want = _reference_loop(params, prompts, cfg, 8)
    got = serve_batched.generate(lm_params_from_numpy(_np(params), "cpu"),
                                 prompts, tcfg, 8, "cpu")
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_serve_batched_runs_and_exits_for_a_front_end(capsys):
    gen = serve_batched.main(["--arch", "xlstm-125m", "--batch", "2",
                              "--prompt-len", "5", "--new-tokens", "3",
                              "--device", "cpu"])
    assert gen.shape == (2, 3)
    assert "tok/s on cpu, reduced xlstm-125m" in capsys.readouterr().out
    for name in ("musicgen-medium", "qwen2-vl-2b"):
        with pytest.raises(SystemExit, match="needs a modality frontend"):
            serve_batched.main(["--arch", name, "--device", "cpu"])
