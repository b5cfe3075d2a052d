"""The port's continuous-batching ``ServeEngine`` on the CPU, at reduced
size: against the JAX engine on the same (carried-over) weights, and the
reference engine's own contracts (``tests/test_serving_engine.py``),
ported.

Parity: the port's engine logits at every emitted position (recorded
through its hooks) against the JAX model teacher-forced with the port's
tokens, within TOL (float32, the same operations summed in other orders,
measured ≲ 2e-6); each token must equal the reference's argmax wherever
the reference's top-2 margin exceeds 2·TOL, and the completions must equal
the JAX engine's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.serving import LoadGen as JLoadGen  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import (LoadGen, Request, ServeEngine,  # noqa: E402
                                 latency_stats, replay)
from repro_torch.serving.engine import (_invalidate_pads,  # noqa: E402
                                        _write_slot)
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
# the request sets of tests/test_serving_engine.py: (prompt len, max new)
GREEDY_SET = [(5, 6), (16, 4), (9, 8), (12, 3), (3, 10), (16, 5)]
RAGGED_SET = [(4 + i, 2 + (i % 5)) for i in range(7)]


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(
        reduced(get_arch("llama3-8b"), n_layers=2, d_model=128), vocab=256)
    tcfg = dataclasses.replace(
        treduced(tregistry.get_arch("llama3-8b"), n_layers=2, d_model=128),
        vocab=256)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, tcfg, params, tparams


def _requests(cfg, spec, seed, uid0=0):
    rng = np.random.default_rng(seed)
    return [(uid0 + i,
             rng.integers(1, cfg.vocab, size=n).astype(np.int32), m)
            for i, (n, m) in enumerate(spec)]


class RecordingEngine(ServeEngine):
    """Records the logits row each emitted token was drawn from."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.logits: dict[int, list[np.ndarray]] = {}

    def _prefill_slot(self, s, req, toks, caches):
        logits, single = super()._prefill_slot(s, req, toks, caches)
        self.logits[req.uid] = [logits[0, len(req.prompt) - 1].numpy()]
        return logits, single

    def _decode_tick(self, toks, live):
        logits = super()._decode_tick(toks, live)
        for s in live:
            self.logits[self.active[s].uid].append(logits[s].numpy())
        return logits


def reference_generate(tcfg, tparams, prompt: np.ndarray,
                       n_new: int) -> list[int]:
    """Unpadded per-request greedy generation with the port's model."""
    caches = TM.init_caches(tcfg, 1, 256, torch.float32, "cpu")
    logits, caches = TM.serve_prefill(
        tparams, {"tokens": torch.from_numpy(prompt)[None]}, tcfg,
        caches=caches)
    out = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, caches = TM.serve_decode(
            tparams, {"tokens": torch.tensor([[out[-1]]])}, caches, pos,
            tcfg)
        out.append(int(logits[0, 0].argmax()))
        pos += 1
    return out


@pytest.mark.parametrize("spec,slots,buckets,seed", [
    (GREEDY_SET, 3, (8, 16), 0), (RAGGED_SET, 2, (16,), 1)])
def test_engine_matches_jax_engine(setup, spec, slots, buckets, seed):
    cfg, tcfg, params, tparams = setup
    reqs = _requests(cfg, spec, seed)
    jeng = JServeEngine(cfg, params, slots=slots, max_len=128,
                        prefill_buckets=buckets)
    eng = RecordingEngine(tcfg, tparams, slots=slots, max_len=128,
                          prefill_buckets=buckets, device="cpu")
    for uid, prompt, m in reqs:
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    want = {c.uid: c for c in jeng.run()}
    got = {c.uid: c for c in eng.run()}
    assert sorted(got) == sorted(want)
    for uid, prompt, m in reqs:
        toks = got[uid].tokens
        assert len(toks) == m and got[uid].prompt_len == len(prompt)
        assert got[uid].ticks == want[uid].ticks
        # the reference teacher-forced with the port's tokens
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        ref = np.asarray(M.forward(params, {"tokens": jnp.asarray(seq)[None]},
                                   cfg)[0][0, len(prompt) - 1:])
        rec = np.stack(eng.logits[uid])
        np.testing.assert_allclose(rec, ref, rtol=TOL, atol=TOL)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * TOL
        assert np.array_equal(np.asarray(toks)[clear],
                              ref.argmax(-1)[clear]), uid
        assert toks == want[uid].tokens, uid


def test_engine_matches_per_request_greedy(setup):
    _, tcfg, _, tparams = setup
    reqs = _requests(tcfg, GREEDY_SET, 0)
    eng = ServeEngine(tcfg, tparams, slots=3, max_len=256,
                      prefill_buckets=(8, 16), device="cpu")
    for uid, prompt, m in reqs:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    before = dict(fa_ops.launches)
    done = {c.uid: c.tokens for c in eng.run()}
    assert fa_ops.launches == before        # the CPU takes the plain version
    for uid, prompt, m in reqs:
        assert done[uid] == reference_generate(tcfg, tparams, prompt, m)


def test_engine_slot_reuse_and_ragged_phases(setup):
    _, tcfg, _, tparams = setup
    reqs = _requests(tcfg, RAGGED_SET, 1, uid0=100)
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=128,
                      prefill_buckets=(16,), device="cpu")
    for uid, prompt, m in reqs:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    done = eng.run()
    assert sorted(c.uid for c in done) == [uid for uid, _, _ in reqs]
    for c in done:
        assert len(c.tokens) == next(m for uid, _, m in reqs if uid == c.uid)
    assert eng.utilization == 0.0 and not eng.queue


def test_engine_eos_frees_slot(setup):
    _, tcfg, _, tparams = setup
    prompt = np.asarray([5, 6, 7], np.int32)
    want = reference_generate(tcfg, tparams, prompt, 8)
    eng = ServeEngine(tcfg, tparams, slots=1, max_len=64,
                      prefill_buckets=(8,), device="cpu")
    eng.submit(Request(uid=7, prompt=prompt, max_new_tokens=8,
                       eos_id=want[2]))
    done = eng.run()
    assert len(done) == 1 and done[0].tokens == want[:3]
    assert eng.active == [None]


@pytest.mark.parametrize("name,exc", [
    ("xlstm-125m", ValueError), ("zamba2-2.7b", ValueError),
    ("musicgen-medium", ValueError), ("qwen2-vl-2b", ValueError)])
def test_engine_rejects_unservable_configs(name, exc):
    cfg = treduced(tregistry.get_arch(name))
    with pytest.raises(exc):
        ServeEngine(cfg, {}, slots=1, device="cpu")


class JRecordingEngine(JServeEngine):
    """The reference engine, recording as ``RecordingEngine`` does."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.logits: dict[int, list[np.ndarray]] = {}

    def _prefill_slot(self, s, req, toks, caches):
        logits, single = super()._prefill_slot(s, req, toks, caches)
        self.logits[req.uid] = [np.asarray(logits[0, len(req.prompt) - 1])]
        return logits, single

    def _decode_tick(self, toks, live):
        logits = super()._decode_tick(toks, live)
        for s in live:
            self.logits[self.active[s].uid].append(np.asarray(logits[s]))
        return logits


# prompts up to 32 tokens in one bucket of 32: gemma3's past its window
# of 16 (C20), the MoE's decode ticks at capacity 2 with idle slots
MODEL_SET = [(5, 6), (30, 4), (12, 9), (27, 3), (3, 5)]


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "granite-moe-1b-a400m", "gemma3-12b"])
def test_engine_serves_moe_mla_and_window_models(name):
    """Reduced deepseek-v2-lite (MLA, MoE with a shared expert), granite
    (MoE) and gemma3 (a local and a global layer) behind both engines,
    3 slots: every completion token-equal to the reference engine's, and
    the logits of every emitted token within TOL of the reference
    engine's.  A teacher-forced forward is no reference here: the MoE
    drops by batch (a decode tick routes 3 tokens, capacity 2: C19) and
    gemma3's rings lose padded prompts' tokens (C20), in both engines
    alike."""
    dist.unset_mesh()          # C4: a mesh left set by another test file
    cfg = reduced(get_arch(name))
    tcfg = treduced(tregistry.get_arch(name))
    params = jax.jit(M.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    reqs = _requests(cfg, MODEL_SET, 2)
    kw = dict(slots=3, max_len=64, prefill_buckets=(32,))
    jeng = JRecordingEngine(cfg, params, **kw)
    eng = RecordingEngine(tcfg, tparams, device="cpu", **kw)
    for uid, prompt, m in reqs:
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m))
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m))
    want = {c.uid: c for c in jeng.run()}
    got = {c.uid: c for c in eng.run()}
    assert sorted(got) == sorted(want) == [uid for uid, _, _ in reqs]
    for uid, prompt, m in reqs:
        assert got[uid].tokens == want[uid].tokens, uid
        assert len(got[uid].tokens) == m
        assert got[uid].ticks == want[uid].ticks
        np.testing.assert_allclose(np.stack(eng.logits[uid]),
                                   np.stack(jeng.logits[uid]), rtol=TOL,
                                   atol=TOL)


def test_engine_rejects_long_prompt(setup):
    _, tcfg, _, tparams = setup
    eng = ServeEngine(tcfg, tparams, slots=1, max_len=64,
                      prefill_buckets=(8, 128), device="cpu")
    assert eng.buckets == (8,)              # buckets beyond max_len dropped
    with pytest.raises(ValueError, match="longer than"):
        eng.submit(Request(uid=0, prompt=np.ones(9, np.int32)))


def test_admission_bound_sheds_overflow(setup):
    _, tcfg, _, tparams = setup
    rng = np.random.default_rng(3)
    reqs = [Request(uid=200 + i,
                    prompt=rng.integers(1, tcfg.vocab, 4).astype(np.int32),
                    max_new_tokens=2) for i in range(5)]
    eng = ServeEngine(tcfg, tparams, slots=1, max_len=64,
                      prefill_buckets=(8,), max_pending=2, device="cpu")
    for r in reqs:
        eng.submit(r)
    assert len(eng.queue) == 2 and eng.dropped == 3
    assert sorted(c.uid for c in eng.run()) == [200, 201]
    assert eng.dropped == 3
    eng2 = ServeEngine(tcfg, tparams, slots=1, max_len=64,
                       prefill_buckets=(8,), device="cpu")
    for r in reqs:
        eng2.submit(dataclasses.replace(r))
    assert len(eng2.queue) == 5 and eng2.dropped == 0


def test_replay_and_latency_stats_surface_dropped(setup):
    _, tcfg, _, tparams = setup
    trace = LoadGen(population=4, rate=3.0, prompt_len=(2, 4),
                    max_new=(2, 3), vocab=tcfg.vocab, seed=0).generate(8)
    eng = ServeEngine(tcfg, tparams, slots=1, max_len=64,
                      prefill_buckets=(8,), max_pending=1, device="cpu")
    stats = replay(eng, trace)
    assert stats["dropped"] == eng.dropped > 0
    assert stats["n_requests"] + stats["dropped"] == len(trace)
    lat = latency_stats(stats["tick_wall"], dropped=stats["dropped"])
    assert lat["dropped"] == float(stats["dropped"])
    assert latency_stats([], dropped=2)["dropped"] == 2.0


def test_sampling_independent_of_coscheduled_traffic(setup):
    """A sampled request's tokens depend only on (uid, step): alone, among
    other traffic, and in another admission order they are identical."""
    _, tcfg, _, tparams = setup

    def sampler(logits, gen):
        return torch.multinomial(torch.softmax(logits, -1), 1, generator=gen)

    rng = np.random.default_rng(7)
    target = Request(uid=42, max_new_tokens=6,
                     prompt=rng.integers(1, tcfg.vocab, 9).astype(np.int32))
    noise = [Request(uid=i, max_new_tokens=3 + i,
                     prompt=rng.integers(1, tcfg.vocab, 4 + i).astype(
                         np.int32)) for i in range(4)]

    def serve(reqs, slots):
        eng = ServeEngine(tcfg, tparams, slots=slots, max_len=128,
                          prefill_buckets=(8, 16), sampler=sampler,
                          device="cpu")
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        return {c.uid: c.tokens for c in eng.run()}

    alone = serve([target], 1)[42]
    assert alone == serve(noise[:2] + [target] + noise[2:], 3)[42]
    assert alone == serve([target] + noise, 2)[42]
    greedy = ServeEngine(tcfg, tparams, slots=1, max_len=128,
                         prefill_buckets=(16,), device="cpu")
    greedy.submit(dataclasses.replace(target))
    assert greedy.run()[0].tokens != alone   # the sampler really sampled


@pytest.mark.parametrize("kw", [
    {}, dict(population=100, rate=2.5, skew=3.0, seed=5),
    dict(prompt_len=(1, 64), max_new=(1, 1), vocab=50, seed=11)])
def test_loadgen_traces_match_reference(kw):
    want = JLoadGen(**kw).generate(40)
    got = LoadGen(**kw).generate(40)
    assert len(got) == len(want)
    for (tg, rg), (tw, rw) in zip(got, want):
        assert tg == tw and rg.uid == rw.uid
        assert rg.client_id == rw.client_id
        assert rg.max_new_tokens == rw.max_new_tokens
        np.testing.assert_array_equal(rg.prompt, rw.prompt)


def test_invalidate_pads_and_write_slot(setup):
    """A right-padded prefill's pad slots leave the valid mask, and the
    filled row lands in its slot of the pool and nowhere else."""
    _, tcfg, _, tparams = setup
    single = TM.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    toks = torch.arange(1, 17)[None]
    _, filled, _ = TM.forward(tparams, {"tokens": toks}, tcfg,
                              caches=single)
    assert (single[0]["pos"] == -1).all()      # the template is untouched
    fixed = _invalidate_pads(filled, 11, 16)
    pos = fixed[0]["pos"][0, 0, 0]
    assert pos[:11].tolist() == list(range(11))
    assert (pos[11:] == -1).all()
    pool = TM.init_caches(tcfg, 3, 32, torch.float32, "cpu")
    _write_slot(pool, fixed, 1)
    for key in ("k", "v", "pos", "idx"):
        assert torch.equal(pool[0][key][:, :, 1:2], fixed[0][key])
        assert torch.equal(pool[0][key][:, :, 0],
                           single[0][key][:, :, 0].expand_as(
                               pool[0][key][:, :, 0]))
    assert pool[0]["idx"][0, 0].tolist() == [0, 16, 0]
