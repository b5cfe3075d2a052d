"""The port's personalized serving (``repro_torch.serving.personalized``)
on the CPU, against the reference's (``repro.serving.personalized``) on
the reference test's reduced llama3 (2 layers, d_model 128, vocab 256,
float32) with the same weights and the same snapshot arrays.

``none`` must be bit-equal to the port's own ``ServeEngine`` (the shared
path IS its call); ``nu`` and ``lowrank`` logits at every emitted position
within TOL of the reference engine's (the same float32 operations summed
in other orders, as tests/test_torch_serving.py measures), and their
completions equal.  The reference's model code runs after
``repro.dist.unset_mesh()``: ``tests/test_personalized_serving.py``'s
lowering test leaves a global mesh set that later reference decodes trip
on when they share a worker with it."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import personalized as jpers  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import (LoadGen, PersonalizedServeEngine,  # noqa
                                 Request, ServeEngine, load_snapshot,
                                 lowrank_factors, make_personalizer,
                                 make_snapshot, personalized_decode, replay,
                                 save_snapshot)
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
SHAPES = [(5, 6), (16, 4), (9, 8), (12, 3)]
ENGINE = dict(max_len=128, prefill_buckets=(8, 16), device="cpu")
JENGINE = dict(max_len=128, prefill_buckets=(8, 16))


@pytest.fixture(autouse=True)
def _no_global_mesh():
    dist.unset_mesh()


@pytest.fixture(scope="module")
def setup():
    dist.unset_mesh()
    cfg = dataclasses.replace(
        reduced(get_arch("llama3-8b"), n_layers=2, d_model=128), vocab=256)
    tcfg = dataclasses.replace(
        treduced(tregistry.get_arch("llama3-8b"), n_layers=2, d_model=128),
        vocab=256)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jspec = jflat.make_flat_spec(params)
    spec = flat.make_flat_spec(tparams)
    base = flat.ravel(spec, tparams)
    np.testing.assert_array_equal(np.asarray(jflat.ravel(jspec, params)),
                                  base.numpy())
    rng = np.random.default_rng(1)
    nu = (1e-3 * rng.standard_normal(spec.p)).astype(np.float32)
    nu_i = (nu[None] + 1e-2 * rng.standard_normal((3, spec.p))
            ).astype(np.float32)
    nu[spec.n:] = 0
    nu_i[:, spec.n:] = 0
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                jspec=jspec, spec=spec, base=base, nu=nu, nu_i=nu_i)


def _requests(vocab, shapes, seed=0, clients=None):
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(1, vocab, size=n).astype(np.int32),
                    max_new_tokens=m,
                    client_id=clients[i] if clients else i % 3)
            for i, (n, m) in enumerate(shapes)]


def _recording(cls, to_numpy):
    """``cls`` recording the logits row each emitted token was drawn
    from."""
    class Recording(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.logits = {}

        def _prefill_slot(self, s, req, toks, caches):
            logits, single = super()._prefill_slot(s, req, toks, caches)
            self.logits[req.uid] = [
                to_numpy(logits[0, len(req.prompt) - 1])]
            return logits, single

        def _decode_tick(self, toks, live):
            logits = super()._decode_tick(toks, live)
            for s in live:
                self.logits[self.active[s].uid].append(to_numpy(logits[s]))
            return logits

    return Recording


PortRecording = _recording(PersonalizedServeEngine, lambda t: t.numpy())
PlainRecording = _recording(ServeEngine, lambda t: t.numpy())
JaxRecording = _recording(jserving.PersonalizedServeEngine, np.asarray)


def _serve(eng, reqs, request_cls=Request):
    for r in reqs:
        eng.submit(request_cls(**dataclasses.asdict(r)))
    return {c.uid: c for c in eng.run()}


def _snapshots(st, kind, version=0, base=None):
    """The same snapshot for both packages (port, reference)."""
    base = st["base"] if base is None else base
    kw = {}
    if kind == "nu":
        kw = dict(nu=st["nu"], nu_i=st["nu_i"])
    elif kind == "lowrank":
        coeff, basis = lowrank_factors(torch.from_numpy(st["nu_i"]),
                                       torch.from_numpy(st["nu"]), r=3)
        kw = dict(coeff=coeff.numpy(), basis=basis.numpy())
    return (make_snapshot(version, base, **kw),
            jpers.make_snapshot(version, jnp.asarray(base.numpy()),
                                **{k: jnp.asarray(v) for k, v in kw.items()}))


# -- the shared path against the plain engine ---------------------------------


@pytest.mark.parametrize("sampled", [False, True])
def test_none_is_bit_equal_to_plain_engine(setup, sampled):
    """``personalizer="none"`` serves the plain engine's tokens and logits,
    bit for bit, greedy and under a sampler."""
    st = setup
    sampler = None
    if sampled:
        def sampler(logits, gen):
            return torch.multinomial(torch.softmax(logits, -1), 1,
                                     generator=gen)[0]
    reqs = _requests(st["cfg"].vocab, SHAPES, seed=3 if sampled else 0)
    plain = PlainRecording(st["tcfg"], st["tparams"], slots=2,
                           sampler=sampler, **ENGINE)
    done0 = _serve(plain, reqs)
    eng = PortRecording(st["tcfg"], st["spec"], _snapshots(st, "none")[0],
                        personalizer="none", slots=2, sampler=sampler,
                        **ENGINE)
    done1 = _serve(eng, reqs)
    assert {u: c.tokens for u, c in done0.items()} \
        == {u: c.tokens for u, c in done1.items()}
    for uid, rows in plain.logits.items():
        for a, b in zip(rows, eng.logits[uid]):
            np.testing.assert_array_equal(a, b)


# -- the row path against the reference engine --------------------------------


@pytest.mark.parametrize("kind", ["nu", "lowrank"])
def test_personalized_logits_match_reference_engine(setup, kind):
    """``nu`` and ``lowrank`` (scale 0.7) with personalized and cold-start
    clients batched together: every emitted position's logits within TOL
    of the reference engine's, the completions and versions equal."""
    st = setup
    snap, jsnap = _snapshots(st, kind, version=4)
    reqs = _requests(st["cfg"].vocab, SHAPES, clients=[0, 999, 1, 2])
    eng = PortRecording(st["tcfg"], st["spec"], snap, personalizer=kind,
                        scale=0.7, slots=2, **ENGINE)
    jeng = JaxRecording(st["cfg"], st["jspec"], jsnap, personalizer=kind,
                        scale=0.7, slots=2, **JENGINE)
    done = _serve(eng, reqs)
    jdone = _serve(jeng, reqs, jserving.Request)
    assert {u: (c.tokens, c.version) for u, c in done.items()} \
        == {u: (c.tokens, c.version) for u, c in jdone.items()}
    worst = max(float(np.abs(a - b).max())
                for uid in eng.logits
                for a, b in zip(eng.logits[uid], jeng.logits[uid]))
    assert worst <= TOL, worst


def test_personalized_decode_matches_reference_and_plain_decode(setup):
    """One row-path tick: ``personalized_decode`` against the reference's
    (within TOL) and against the port's own batch-1 decode on each summed
    row (exactly: vmap changes no operation)."""
    st = setup
    tcfg, spec = st["tcfg"], st["spec"]
    rng = np.random.default_rng(3)
    deltas = (1e-3 * rng.standard_normal((2, spec.p))).astype(np.float32)
    deltas[:, spec.n:] = 0
    rows = st["base"][None] + torch.from_numpy(deltas)
    toks = np.array([[5], [9]], np.int32)
    caches = TM.init_caches(tcfg, 2, 64, torch.float32, "cpu")
    with torch.inference_mode():
        logits, _ = personalized_decode(spec, tcfg, rows,
                                        torch.from_numpy(toks), caches,
                                        torch.zeros(2, dtype=torch.int32))
    jlogits, _ = jpers.personalized_decode(
        st["jspec"], st["cfg"], jnp.asarray(rows.numpy()),
        jnp.asarray(toks), JM.init_caches(st["cfg"], 2, 64, jnp.float32),
        jnp.zeros((2,), jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=0)
    for i in range(2):
        one, _ = TM.serve_decode(
            flat.unravel(spec, rows[i]),
            {"tokens": torch.from_numpy(toks[i])[None]},
            TM.init_caches(tcfg, 1, 64, torch.float32, "cpu"), 0, tcfg)
        torch.testing.assert_close(logits[i], one[0, 0], atol=0, rtol=0)


def test_lowrank_exact_at_full_rank(setup):
    """At r = rank the factors reconstruct the ν deltas (compared as deltas:
    the basis's signs and method are free) as the reference's do, and the
    lowrank engine serves the nu engine's tokens."""
    st = setup
    nu_i, nu = torch.from_numpy(st["nu_i"]), torch.from_numpy(st["nu"])
    coeff, basis = lowrank_factors(nu_i, nu, r=3)
    assert coeff.shape == (3, 3) and basis.shape == (3, st["spec"].p)
    torch.testing.assert_close(basis @ basis.T, torch.eye(3), atol=1e-5,
                               rtol=0)
    deltas = (coeff @ basis).numpy()
    np.testing.assert_allclose(deltas, st["nu_i"] - st["nu"][None],
                               atol=1e-4, rtol=0)
    jc, jb = jpers.lowrank_factors(jnp.asarray(st["nu_i"]),
                                   jnp.asarray(st["nu"]), r=3)
    np.testing.assert_allclose(deltas, np.asarray(jc @ jb), atol=1e-4,
                               rtol=0)
    # r below the rank: the projection onto the first r rows' span
    c2, b2 = lowrank_factors(nu_i, nu, r=2)
    assert b2.shape == (2, st["spec"].p)
    np.testing.assert_allclose((c2 @ b2).numpy()[:2], deltas[:2],
                               atol=1e-4, rtol=0)
    reqs = _requests(st["cfg"].vocab, SHAPES)
    done = {}
    for kind in ("nu", "lowrank"):
        done[kind] = _serve(PersonalizedServeEngine(
            st["tcfg"], st["spec"], _snapshots(st, kind)[0],
            personalizer=kind, slots=2, **ENGINE), reqs)
    assert {u: c.tokens for u, c in done["nu"].items()} \
        == {u: c.tokens for u, c in done["lowrank"].items()}


def test_cold_start_client_serves_base(setup):
    st = setup
    eng = PersonalizedServeEngine(st["tcfg"], st["spec"],
                                  _snapshots(st, "nu")[0], personalizer="nu",
                                  slots=2, **ENGINE)
    assert eng.resolve(999) is None and eng.resolve(-1) is None
    req = _requests(st["cfg"].vocab, [(7, 5)], clients=[999])[0]
    plain = ServeEngine(st["tcfg"], st["tparams"], slots=2, **ENGINE)
    assert _serve(eng, [req])[0].tokens == _serve(plain, [req])[0].tokens


# -- hot-swap -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["none", "nu"])
def test_hot_swap_preserves_in_flight(setup, kind):
    """A swap between ticks changes no token of a request admitted before
    it, on the shared, grouped and row paths; completions record the
    version they were admitted under, and the post-swap request sees the
    new base."""
    st = setup
    rng = np.random.default_rng(9)
    base2 = st["base"] + torch.from_numpy(
        (1e-2 * rng.standard_normal(st["spec"].p)).astype(np.float32))
    base2[st["spec"].n:] = 0
    pre = _requests(st["cfg"].vocab, [(6, 12)], seed=1, clients=[0])[0]
    post = dataclasses.replace(
        _requests(st["cfg"].vocab, [(6, 6)], seed=2, clients=[1])[0], uid=1)

    def engine(version, base):
        return PersonalizedServeEngine(
            st["tcfg"], st["spec"], _snapshots(st, kind, version, base)[0],
            personalizer=kind, slots=2, max_len=128, prefill_buckets=(8,),
            device="cpu")

    def serve(swap):
        eng = engine(3, st["base"])
        eng.submit(dataclasses.replace(pre))
        for _ in range(4):
            eng.step()
        if swap:
            assert eng.swap(_snapshots(st, kind, 7, base2)[0]) == 7
        eng.submit(dataclasses.replace(post))
        return {c.uid: c for c in eng.run()}

    plain, swapped = serve(False), serve(True)
    assert swapped[0].tokens == plain[0].tokens
    assert swapped[0].version == 3 and swapped[1].version == 7
    assert plain[1].version == 3
    fresh = engine(7, base2)
    fresh.submit(dataclasses.replace(post))
    assert swapped[1].tokens == fresh.run()[0].tokens


def test_grouped_path_splices_versions(setup):
    """Two base-only versions in flight decode through the grouped path:
    each request's tokens equal those of an engine that served it alone
    under its own version."""
    st = setup
    base2 = st["base"] * 1.01
    reqs = _requests(st["cfg"].vocab, [(6, 10), (7, 6)], seed=5)
    eng = PersonalizedServeEngine(st["tcfg"], st["spec"],
                                  make_snapshot(1, st["base"]), slots=2,
                                  **ENGINE)
    calls = []
    real = eng._decode_grouped

    def counted(*a):
        calls.append(1)
        return real(*a)
    eng._decode_grouped = counted
    eng.submit(dataclasses.replace(reqs[0]))
    eng.step()
    eng.swap(make_snapshot(2, base2))
    eng.submit(dataclasses.replace(reqs[1]))
    done = {c.uid: c for c in eng.run()}
    assert calls and done[0].version == 1 and done[1].version == 2
    for r, b in zip(reqs, (st["base"], base2)):
        alone = PersonalizedServeEngine(st["tcfg"], st["spec"],
                                        make_snapshot(0, b), slots=2,
                                        **ENGINE)
        assert _serve(alone, [r])[r.uid].tokens == done[r.uid].tokens


def test_swap_gc_drops_dead_versions(setup):
    st = setup
    eng = PersonalizedServeEngine(st["tcfg"], st["spec"],
                                  make_snapshot(1, st["base"]), slots=2,
                                  **ENGINE)
    done = _serve(eng, _requests(st["cfg"].vocab, [(5, 3)]))
    assert done[0].version == 1
    eng.swap(make_snapshot(2, st["base"]))
    eng.swap(make_snapshot(5, st["base"]))
    assert sorted(eng._versions) == [5]


def test_replay_swaps_mid_stream(setup):
    st = setup
    eng = PersonalizedServeEngine(st["tcfg"], st["spec"],
                                  make_snapshot(0, st["base"]), slots=2,
                                  **ENGINE)
    trace = LoadGen(population=8, rate=0.5, prompt_len=(3, 8),
                    max_new=(4, 8), vocab=st["cfg"].vocab,
                    seed=2).generate(12)
    stats = replay(eng, trace, swap_at=4,
                   snapshot=make_snapshot(1, st["base"]))
    assert {c.version for c in stats["completions"]} == {0, 1}


# -- the registry and snapshots -----------------------------------------------


@pytest.mark.parametrize("name,keys", [("bogus", {}), ("nu", {}),
                                       ("lowrank", {})])
def test_registry_errors_are_the_reference_s(setup, name, keys):
    st = setup
    with pytest.raises(ValueError) as want:
        jpers.make_personalizer(name, jpers.make_snapshot(
            0, jnp.asarray(st["base"].numpy())))
    with pytest.raises(ValueError) as got:
        make_personalizer(name, make_snapshot(0, st["base"]))
    assert str(got.value) == str(want.value)


def test_lowrank_resolution_flat_in_population(setup):
    st = setup
    m, p = 100_000, st["spec"].p
    gen = torch.Generator().manual_seed(0)
    coeff = 1e-3 * torch.randn(m, 4, generator=gen)
    basis = torch.randn(4, p, generator=gen)
    fn = make_personalizer("lowrank", make_snapshot(0, st["base"],
                                                    coeff=coeff,
                                                    basis=basis))
    torch.testing.assert_close(fn(m - 1), coeff[m - 1] @ basis)
    assert fn(m) is None and fn(-1) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_files_cross_packages(setup, writer, tmp_path):
    """A snapshot written by either package loads in the other, version
    and arrays equal, and both packages write the same bytes."""
    st = setup
    snap, jsnap = _snapshots(st, "lowrank", version=6)
    snap = dict(snap, nu=torch.from_numpy(st["nu"]),
                nu_i=torch.from_numpy(st["nu_i"]))
    jsnap = dict(jsnap, nu=jnp.asarray(st["nu"]),
                 nu_i=jnp.asarray(st["nu_i"]))
    path = str(tmp_path / "snap.msgpack")
    other = str(tmp_path / "other.msgpack")
    if writer == "port":
        save_snapshot(path, snap)
        jpers.save_snapshot(other, jsnap)
        back = {k: np.asarray(v) for k, v in
                jpers.load_snapshot(path).items()}
    else:
        jpers.save_snapshot(path, jsnap)
        save_snapshot(other, snap)
        back = {k: np.asarray(v) for k, v in load_snapshot(path).items()}
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()
    assert sorted(back) == sorted(snap)
    assert back["version"].shape == () and int(back["version"]) == 6
    for k, v in snap.items():
        if k != "version":
            np.testing.assert_array_equal(back[k], np.asarray(v))


# -- the twins ----------------------------------------------------------------


def test_personalized_serving_example_twin(capsys):
    """The example at ``--small``: the in-flight request drains under its
    pinned version, the new admissions under the swapped one (the
    example's own assertions), and every completion is whole."""
    from repro_torch.examples import personalized_serving
    out = personalized_serving.main(["--small", "--device", "cpu"])
    assert "OK — in-flight request drained under v4" in \
        capsys.readouterr().out
    assert sorted(out["snapshots"]) == [4, 8]
    assert {c.version for c in out["stats2"]["completions"]} == {4, 8}
    assert out["stats"]["n_requests"] == 12

