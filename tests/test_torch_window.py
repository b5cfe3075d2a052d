"""Sliding-window layers in the port against the reference on the CPU:
``blocked_attention``'s kv band, and gemma3's local rings behind
``ServeEngine`` (reduced gemma3-12b: a local layer of window 16, then a
global one; float32, the reference's weights carried across).

The engine is exact where its ring holds every key of each query's
window: a prompt that fills its bucket, the bucket no longer than the
window (decode steps may cross the ring's end); ``serve_prefill`` /
``serve_decode`` without the engine are exact over the window too (the
whole-ring gather).  Behind the engine a bucket longer than the window is
not, in the reference as in the port (ROADMAP C20): the ring keeps the
bucket's last ``window`` positions, pads included, so real tokens before
them are gone; the pad mask takes ring slots ≥ ``n % window``, every slot
when the prompt fills a bucket that is a multiple of the window; and the
decode writes start at slot ``bucket % window``, over real tokens still
inside the window.  The port loses the same tokens as the reference,
whose logits it matches within TOL."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
WINDOW = 16                      # reduced gemma3's sliding window


@pytest.fixture(autouse=True)
def _no_mesh():
    dist.unset_mesh()          # C4: a mesh left set by another test file


@pytest.fixture(scope="module")
def gemma3():
    cfg = dataclasses.replace(reduced(get_arch("gemma3-12b")), vocab=256)
    tcfg = dataclasses.replace(treduced(tregistry.get_arch("gemma3-12b")),
                               vocab=256)
    assert cfg.sliding_window == WINDOW and cfg.global_every == 2
    params = jax.jit(M.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    return cfg, tcfg, params, lm_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


# -- the kv band ---------------------------------------------------------------

def _qkv(S, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((1, S, 2, 16), (1, S, 1, 16), (1, S, 1, 16))]


@pytest.mark.parametrize("logit_cap,window", [(5.0, 16), (0.0, 100),
                                              (5.0, 700)])
def test_kv_band_matches_reference(logit_cap, window):
    """S = 1024 in blocks of 512: a local layer's in-flight blocks score
    only the ``window + 512`` keys ending with the block, in both
    packages."""
    q, k, v = _qkv(1024, 1)
    pos = np.arange(1024, dtype=np.int32)
    want = jattn.blocked_attention(
        *(jnp.asarray(a) for a in (q, k, v, pos, pos)), window=window,
        is_global=False, logit_cap=logit_cap)
    got = tattn.blocked_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos, pos)), window=window,
        is_global=False, logit_cap=logit_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [16, 100, 700])
def test_kv_band_changes_nothing(window, monkeypatch):
    """The band against every key masked (a tensor ``is_global`` takes
    no band): the same values up to the order of the float32 sums, the
    band's scores a fraction of the full ones."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1024, 2))
    pos = torch.arange(1024, dtype=torch.int32)
    widths = []
    einsum = torch.einsum

    def counting(eq, a, b):
        if eq == "bqhgd,bkhd->bhgqk":
            widths.append(b.shape[1])
        return einsum(eq, a, b)

    monkeypatch.setattr(torch, "einsum", counting)
    band = tattn.blocked_attention(q, k, v, pos, pos, window=window,
                                   is_global=False, logit_cap=5.0)
    assert widths == [min(1024, window + 512)] * 2
    full = tattn.blocked_attention(q, k, v, pos, pos, window=window,
                                   is_global=torch.tensor(False),
                                   logit_cap=5.0)
    assert widths[2:] == [1024, 1024]
    np.testing.assert_allclose(band.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)


# -- gemma3's rings behind the engine ------------------------------------------

class _Recorder:
    """The logits each emitted token was drawn from, by uid, through the
    engines' hooks."""

    def _prefill_slot(self, s, req, toks, caches):
        logits, single = super()._prefill_slot(s, req, toks, caches)
        self.logits.setdefault(req.uid, []).append(
            np.asarray(logits[0, len(req.prompt) - 1], np.float32))
        return logits, single

    def _decode_tick(self, toks, live):
        logits = super()._decode_tick(toks, live)
        rows = np.asarray(logits, np.float32)
        for s in live:
            self.logits[self.active[s].uid].append(rows[s])
        return logits


class _Port(_Recorder, ServeEngine):
    logits: dict


class _Ref(_Recorder, JServeEngine):
    logits: dict


def _engines(gemma3, n, bucket, max_new, seed=0):
    cfg, tcfg, params, tparams = gemma3
    prompt = np.random.default_rng(seed).integers(1, cfg.vocab, n).astype(
        np.int32)
    kw = dict(slots=1, max_len=64, prefill_buckets=(bucket,))
    port = _Port(tcfg, tparams, device="cpu", **kw)
    ref = _Ref(cfg, params, **kw)
    for eng in (port, ref):
        eng.logits = {}
    port.submit(Request(uid=0, prompt=prompt, max_new_tokens=max_new))
    ref.submit(JRequest(uid=0, prompt=prompt, max_new_tokens=max_new))
    return prompt, port, ref


def _local_pos(eng) -> np.ndarray:
    """Slot 0's ring positions in the local layer (segment 0)."""
    return np.asarray(eng.caches[0]["pos"])[0, 0, 0]


def _teacher_forced(gemma3, prompt, tokens) -> np.ndarray:
    """The reference's no-cache forward over prompt + emitted tokens: the
    logits at each emitting position."""
    cfg, _, params, _ = gemma3
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)])
    out = jax.jit(lambda t: M.forward(params, {"tokens": t}, cfg)[0])(
        jnp.asarray(seq)[None])
    return np.asarray(out[0, len(prompt) - 1:])


def test_padded_prefill_over_the_window_loses_the_same_tokens(gemma3):
    """C20: a prompt of 24 in bucket 32 (window 16).  The ring keeps
    bucket positions 16-31; the pads 24-31 are hidden, so real positions
    9-15, inside position 24's window (> 24 − 16), are gone, and the first
    decode writes position 24 into slot 32 % 16 = 0 over position 16.
    The port's ring equals the reference's after each step, its logits
    the reference engine's; both differ from the no-cache forward."""
    prompt, port, ref = _engines(gemma3, 24, 32, 4)
    port._admit()
    ref._admit()
    want = np.r_[np.arange(16, 24), np.full(8, -1)]
    np.testing.assert_array_equal(_local_pos(port), want)
    np.testing.assert_array_equal(_local_pos(ref), want)
    port._tick()
    ref._tick()
    want[0] = 24
    np.testing.assert_array_equal(_local_pos(port), want)
    np.testing.assert_array_equal(_local_pos(ref), want)
    got = {c.uid: c.tokens for c in port.run()}
    assert got == {c.uid: c.tokens for c in ref.run()}
    rec, jrec = np.stack(port.logits[0]), np.stack(ref.logits[0])
    np.testing.assert_allclose(rec, jrec, rtol=TOL, atol=TOL)
    exact = _teacher_forced(gemma3, prompt, got[0])
    np.testing.assert_allclose(rec[0], exact[0], rtol=TOL, atol=TOL)
    assert np.abs(rec[1:] - exact[1:]).max() > 1e-3   # the lost tokens


def test_prompt_filling_a_multiple_of_the_window_loses_the_ring(gemma3):
    """C20: n = bucket = 32, a multiple of the window: no pad, but the
    pad mask takes ring slots ≥ 32 % 16 = 0, every slot, in both packages;
    the local layer's decodes see no prompt token."""
    prompt, port, ref = _engines(gemma3, 32, 32, 6, seed=1)
    port._admit()
    ref._admit()
    np.testing.assert_array_equal(_local_pos(port), np.full(WINDOW, -1))
    np.testing.assert_array_equal(_local_pos(ref), np.full(WINDOW, -1))
    got = {c.uid: c.tokens for c in port.run()}
    assert got == {c.uid: c.tokens for c in ref.run()}
    rec = np.stack(port.logits[0])
    np.testing.assert_allclose(rec, np.stack(ref.logits[0]), rtol=TOL,
                               atol=TOL)
    exact = _teacher_forced(gemma3, prompt, got[0])
    assert np.abs(rec[1:] - exact[1:]).max() > 1e-3


def test_prompt_filling_its_bucket_under_the_window_is_exact(gemma3):
    """n = bucket = 12 ≤ the window, 8 tokens whose decode steps cross
    the ring's end (12 + 7 > 16): the engine's logits equal the no-cache
    forward's, in both packages."""
    n, max_new = 12, 8
    prompt, port, ref = _engines(gemma3, n, n, max_new, seed=2)
    got = {c.uid: c.tokens for c in port.run()}
    assert got == {c.uid: c.tokens for c in ref.run()}
    rec = np.stack(port.logits[0])
    np.testing.assert_allclose(rec, np.stack(ref.logits[0]), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(rec, _teacher_forced(gemma3, prompt, got[0]),
                               rtol=TOL, atol=TOL)
    ring = _local_pos(port)
    assert sorted(ring) == list(range(n + max_new - 1 - WINDOW,
                                      n + max_new - 1))


def test_whole_ring_gather_is_exact_without_the_engine(gemma3):
    """``serve_prefill`` of 40 tokens (over the window: the local ring
    takes the last 16 by one gather) and 6 ``serve_decode`` steps, with
    no pad mask: the logits equal the no-cache forward's, and the
    reference's serve path's."""
    cfg, tcfg, params, tparams = gemma3
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (1, 46)).astype(
        np.int32)
    want = _teacher_forced(gemma3, toks[0, :1], toks[0, 1:])
    caches = M.init_caches(cfg, 1, 64, jnp.float32)
    tcaches = TM.init_caches(tcfg, 1, 64, torch.float32, "cpu")
    decode = jax.jit(lambda t, c, p: M.serve_decode(params, {"tokens": t},
                                                    c, p, cfg))
    jl, caches = jax.jit(lambda t, c: M.serve_prefill(
        params, {"tokens": t}, cfg, caches=c))(jnp.asarray(toks[:, :40]),
                                                caches)
    tl, tcaches = TM.serve_prefill(
        tparams, {"tokens": torch.from_numpy(toks[:, :40])}, tcfg,
        caches=tcaches)
    np.testing.assert_allclose(tl[0, -1].numpy(), want[39], rtol=TOL,
                               atol=TOL)
    assert sorted(tcaches[0]["pos"][0, 0, 0].tolist()) == list(range(24, 40))
    for p in range(40, 45):
        tok = toks[:, p:p + 1]
        jl, caches = decode(jnp.asarray(tok), caches, p)
        tl, tcaches = TM.serve_decode(tparams, {"tokens": torch.from_numpy(
            tok)}, tcaches, p, tcfg)
        np.testing.assert_allclose(tl[0, 0].numpy(), want[p], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tl[0, 0].numpy(), np.asarray(jl[0, 0]),
                                   rtol=TOL, atol=TOL)
