"""Partial participation in the port (fed/population.py, the flat cohort
round, the population chunk and the simulation's cohort path) against the
JAX package on the CPU.

* The Feistel draw: ``_mix`` and ``_permutation_points`` bit-equal to the
  reference's given its round keys (``jax.random.bits(key, (4,),
  uint32)``), over powers of two and other sizes.
* ``round_robin`` ids and every sampler's ``cohort_weights`` equal to the
  reference's for the same ids, to the last bit; ``from_config`` builds
  the same population.
* Each sampler's own contract: C ids in range, distinct except
  ``weighted``, reproducible, reading no torch RNG, unavailable clients
  only as fill.
* Every sampler's cohort equals the reference's ``host_cohort`` on a grid
  (M ∈ {37, 1000, 100000}, seeds 0 and 1, t = 0-9, availability 0.6 and
  random weights): the keyed draws of ``fed/keyed.py`` (round keys,
  ``jnp.cumsum``'s order, ``choice``'s ``searchsorted``, the fold-like
  split, Gumbel scores and ``top_k``'s tie order).  numpy's float32
  ``log`` may differ from XLA's by an ulp (``GUMBEL_MAX_ULP``), so an
  availability cohort could differ where two candidates' scores lie that
  close; on this grid none does.
* ``make_flat_cohort_round`` against the reference's, fed the reference's
  ``host_cohort`` ids, the same batches, K rows and weights: fedagrac,
  fedavg, fednova and scaffold, ``nu_decay`` 0 and 0.3, and a ``weighted``
  cohort with a repeated id, over 3 rounds.  Tolerances are
  tests/test_torch_round.py's (float32 rounding of other summation orders:
  params rtol 1e-5 / atol 2e-6; ν and ν⁽ⁱ⁾, from ``recover_avg_grad``'s
  division by η·K_i, atol 1e-5).
* The simulation's chunked cohort run equal, bit for bit, to its per-round
  run.
"""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.fed import population as jpop  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import engine, flat, rounds  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.data import FederatedBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.fed import population as tpop  # noqa: E402
from repro_torch.models import simple  # noqa: E402

M, C, B, D, N_CLASSES, K_MAX = 8, 4, 5, 8, 4, 4
LR, LAM = 0.05, 0.5
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)
PARTIAL = sorted(set(tpop.SAMPLERS) - {"all"})


# ---------------------------------------------------------------------------
# the Feistel draw and the weights, against the reference
# ---------------------------------------------------------------------------

def test_mix_bit_equal():
    x = np.arange(0, 2 ** 32, 2 ** 20 + 7, dtype=np.uint64).astype(np.uint32)
    for k in (0, 1, 0x9E3779B9, 2 ** 32 - 1):
        want = np.asarray(jpop._mix(jnp.asarray(x), jnp.uint32(k)))
        np.testing.assert_array_equal(tpop._mix(x, k), want)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 17, 100, 256, 1000, 4096, 65537,
                               100_000])
def test_permutation_points_bit_equal_given_round_keys(m):
    key = jax.random.PRNGKey(m)
    round_keys = np.asarray(jax.random.bits(key, (4,), jnp.uint32))
    pts = np.arange(min(m, 4096), dtype=np.uint32)
    want = np.asarray(jpop._permutation_points(key, m, jnp.asarray(pts)))
    got = tpop._permutation_points(round_keys, m, pts)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 5, 17, 100, 1000])
def test_permutation_points_bijective(m):
    rks = np.random.default_rng(m).integers(0, 2 ** 32, 4, dtype=np.uint32)
    pts = tpop._permutation_points(rks, m, np.arange(m, dtype=np.uint32))
    assert sorted(pts.tolist()) == list(range(m))


@pytest.mark.parametrize("m,c", [(12, 4), (10, 3), (7, 7)])
def test_round_robin_ids_equal_jax(m, c):
    j = jpop.ClientPopulation(m, cohort_size=c, sampler="round_robin")
    t = tpop.ClientPopulation(m, cohort_size=c, sampler="round_robin")
    for r in range(9):
        ids = t.cohort(r)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, np.asarray(j.cohort(r)))


@pytest.mark.parametrize("c", [1, 4, 8, 11])
@pytest.mark.parametrize("sampler", sorted(tpop.SAMPLERS))
def test_cohort_weights_equal_jax(sampler, c):
    m = 16
    c = m if sampler == "all" else c
    w = np.random.default_rng(c).uniform(0.5, 2.0, m)
    j = jpop.ClientPopulation(m, cohort_size=c, sampler=sampler, weights=w,
                              availability=0.6, seed=3)
    t = tpop.ClientPopulation(m, cohort_size=c, sampler=sampler, weights=w,
                              availability=0.6, seed=3)
    np.testing.assert_array_equal(t.weights, np.asarray(j.weights))
    for r in range(4):
        ids, jw = j.host_cohort(r)
        tw = t.cohort_weights(ids)
        assert tw.dtype == np.float32 and tw.shape == (c,)
        np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("kw", [
    dict(), dict(cohort_size=16), dict(cohort_size=4),
    dict(cohort_size=4, cohort_sampler="weighted"),
    dict(cohort_size=5, cohort_sampler="availability", availability=0.3),
    dict(cohort_size=4, cohort_sampler="round_robin", seed=7),
    dict(cohort_size=16, cohort_sampler="uniform")])
def test_from_config_parity(kw):
    w = np.arange(1, 17, dtype=np.float64)
    j = jpop.ClientPopulation.from_config(JFedConfig(n_clients=16, **kw),
                                          weights=w)
    t = tpop.ClientPopulation.from_config(FedConfig(n_clients=16, **kw),
                                          weights=w)
    assert (j is None) == (t is None)
    if j is None:
        return
    assert (t.m, t.cohort_size, t.sampler, t.seed) == (
        j.m, j.cohort_size, j.sampler, j.seed)
    assert t.full_participation == j.full_participation
    np.testing.assert_array_equal(t.weights, np.asarray(j.weights))
    np.testing.assert_array_equal(t.availability,
                                  np.asarray(j.availability))


def test_population_checks_match_jax():
    for kw in (dict(cohort_size=4, sampler="all"), dict(sampler="nope"),
               dict(cohort_size=13)):
        with pytest.raises(ValueError) as want:
            jpop.ClientPopulation(12, **kw)
        with pytest.raises(ValueError) as got:
            tpop.ClientPopulation(12, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the keyed cohort draws, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [37, 1000, 100_000])
@pytest.mark.parametrize("sampler", PARTIAL)
def test_cohorts_equal_reference_on_grid(sampler, m):
    c = 5 if m == 37 else 8
    for seed in (0, 1):
        w = np.random.default_rng(seed).uniform(0.5, 2.0, m)
        kw = dict(cohort_size=c, sampler=sampler, seed=seed, weights=w,
                  availability=0.6)
        ref = jpop.ClientPopulation(m, **kw)
        pop = tpop.ClientPopulation(m, **kw)
        for t in range(10):
            want_ids, want_w = ref.host_cohort(t)
            ids, cw = pop.host_cohort(t)
            np.testing.assert_array_equal(ids, np.asarray(want_ids))
            np.testing.assert_array_equal(cw, np.asarray(want_w))


def test_full_cohort_equals_reference():
    """C = M under a partial sampler: the permutation of all M."""
    for sampler in ("uniform", "availability"):
        ref = jpop.ClientPopulation(37, cohort_size=37, sampler=sampler,
                                    availability=0.5, seed=4)
        pop = tpop.ClientPopulation(37, cohort_size=37, sampler=sampler,
                                    availability=0.5, seed=4)
        for t in range(3):
            np.testing.assert_array_equal(pop.cohort(t),
                                          np.asarray(ref.cohort(t)))


@pytest.mark.parametrize("n", [5, 16, 17, 255, 4097, 100_000])
def test_cumsum_in_xla_order(n):
    w = np.random.default_rng(n).uniform(0.5, 2.0, n)
    w = (w / w.sum()).astype(np.float32)
    from repro_torch.fed import keyed
    np.testing.assert_array_equal(keyed.cumsum(w),
                                  np.asarray(jnp.cumsum(jnp.asarray(w))))


def test_keyed_split_uniform_range_and_gumbel():
    from repro_torch.fed import keyed
    jkey = jax.random.PRNGKey(9)
    key = keyed.prng_key(9)
    np.testing.assert_array_equal(keyed.split(key),
                                  np.asarray(jax.random.split(jkey)))
    tiny = np.finfo(np.float32).tiny
    for lo, hi in ((tiny, 1.0), (-2.0, 3.0), (0.0, 1.0)):
        np.testing.assert_array_equal(
            keyed.uniform(key, (1000,), minval=lo, maxval=hi),
            np.asarray(jax.random.uniform(jkey, (1000,), minval=lo,
                                          maxval=hi)))
    want = np.asarray(jax.random.gumbel(jkey, (20_000,)))
    got = keyed.gumbel(key, (20_000,))
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    close = np.abs(got - want) <= tpop.GUMBEL_MAX_ULP * np.spacing(
        np.abs(want).astype(np.float32) + np.float32(1.0))
    assert close.all(), (ulp.max(), np.abs(got - want).max())


# ---------------------------------------------------------------------------
# each sampler's own contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", PARTIAL)
def test_cohorts_in_range_sized_and_reproducible(sampler):
    pop = tpop.ClientPopulation(12, cohort_size=4, sampler=sampler, seed=1,
                                availability=0.6)
    again = tpop.ClientPopulation(12, cohort_size=4, sampler=sampler, seed=1,
                                  availability=0.6)
    for t in (0, 1, 9, 1000):
        ids = pop.cohort(t)
        assert ids.shape == (4,) and ids.dtype == np.int32
        assert np.all((0 <= ids) & (ids < 12))
        if sampler != "weighted":          # with replacement may repeat
            assert len(set(ids.tolist())) == 4, (sampler, ids)
        np.testing.assert_array_equal(ids, again.cohort(t))
    draws = {tuple(pop.cohort(t)) for t in range(40)}
    assert len(draws) >= 3                 # rounds differ (M/C = 3 blocks)


@pytest.mark.parametrize("sampler", PARTIAL)
def test_cohort_draws_read_no_torch_state(sampler):
    """The draw is numpy on the host: torch's RNG state and default device
    do not touch it, so the card and the CPU see the same cohorts."""
    pop = tpop.ClientPopulation(20, cohort_size=5, sampler=sampler, seed=4,
                                availability=0.5)
    torch.manual_seed(0)
    first = [pop.cohort_and_weights(t) for t in range(6)]
    torch.manual_seed(123)
    torch.rand(10)
    for t, (ids, w) in enumerate(first):
        ids2, w2 = pop.cohort_and_weights(t)
        np.testing.assert_array_equal(ids, ids2)
        np.testing.assert_array_equal(w, w2)
    src = Path(tpop.__file__).read_text()
    mods = {a.name for node in ast.walk(ast.parse(src))
            if isinstance(node, ast.Import) for a in node.names}
    assert "torch" not in mods


def test_uniform_covers_and_is_unbiased():
    rng = np.random.default_rng(0)
    pop = tpop.ClientPopulation(12, cohort_size=4, sampler="uniform",
                                weights=rng.uniform(0.5, 2.0, 12))
    draws = [pop.cohort(t) for t in range(300)]
    assert {i for d in draws for i in d.tolist()} == set(range(12))
    counts = np.bincount(np.concatenate(draws), minlength=12)
    exp = 300 * 4 / 12
    assert abs(counts - exp).max() < 6 * np.sqrt(exp)
    masses = [float(pop.host_cohort(t)[1].sum()) for t in range(300)]
    assert np.mean(masses) == pytest.approx(1.0, abs=0.05)


def test_round_robin_covers_exactly_once_per_cycle():
    pop = tpop.ClientPopulation(12, cohort_size=4, sampler="round_robin")
    cycle = np.concatenate([pop.cohort(t) for t in range(3)])
    assert sorted(cycle.tolist()) == list(range(12))


def test_weighted_draws_follow_the_weights():
    w = np.ones(10)
    w[3] = 30.0
    pop = tpop.ClientPopulation(10, cohort_size=4, sampler="weighted",
                                weights=w, seed=2)
    ids = np.concatenate([pop.cohort(t) for t in range(200)])
    share = np.mean(ids == 3)
    assert share == pytest.approx(30 / 39, abs=0.05)
    assert any(len(set(pop.cohort(t).tolist())) < 4 for t in range(20))


def test_availability_takes_unavailable_clients_only_as_fill():
    avail = np.zeros(12)
    avail[:4] = 1.0                        # only clients 0…3 are ever up
    pop = tpop.ClientPopulation(12, cohort_size=4, sampler="availability",
                                availability=avail, seed=2)
    for t in range(6):
        assert set(pop.cohort(t).tolist()) == set(range(4))
    avail[:4] = 0.0
    avail[[5, 9]] = 1.0                    # two up, two seats to fill
    pop = tpop.ClientPopulation(12, cohort_size=4, sampler="availability",
                                availability=avail, seed=2)
    ref = jpop.ClientPopulation(12, cohort_size=4, sampler="availability",
                                availability=avail, seed=2)
    fills = set()
    for t in range(10):
        ids = pop.cohort(t)
        assert {5, 9} <= set(ids.tolist()) and len(set(ids.tolist())) == 4
        fills |= set(ids.tolist()) - {5, 9}
        np.testing.assert_array_equal(ids, np.asarray(ref.cohort(t)))
    # the unavailable clients' scores round to the same −1e9 in float32,
    # so, as in the reference's top_k, the fill is the lowest ids
    assert fills == {0, 1}


# ---------------------------------------------------------------------------
# the cohort round against the reference's
# ---------------------------------------------------------------------------

def _configs(algorithm, nu_decay):
    kw = dict(algorithm=algorithm, n_clients=M, lr=LR, calibration_rate=LAM,
              param_layout="flat", cohort_size=C, cohort_nu_decay=nu_decay)
    return JFedConfig(**kw), FedConfig(**kw)


def _round_inputs(sampler, n_rounds=3, seed=5):
    """Numpy params, a population-sized K row, and per round the
    reference's host cohort (ids, weights) and a batch of the cohort."""
    rng = np.random.default_rng(seed)
    params = {"w": (0.5 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": (0.5 * rng.standard_normal(N_CLASSES)).astype(np.float32)}
    k_row = rng.integers(1, K_MAX + 1, M).astype(np.int32)
    k_row[0], k_row[1] = 1, K_MAX
    w = rng.random(M) + 0.5
    pop = jpop.ClientPopulation(M, cohort_size=C, sampler=sampler, seed=2,
                                weights=w)
    rounds_in = []
    for t in range(n_rounds):
        ids, cw = (np.array(a) for a in pop.host_cohort(t))
        if sampler == "weighted" and t == 1:
            ids = np.array([1, 5, 1, 3], np.int32)   # a repeated id
        rounds_in.append((
            ids, cw, k_row[ids],
            {"x": rng.standard_normal((C, K_MAX, B, D)).astype(np.float32),
             "y": rng.integers(0, N_CLASSES, (C, K_MAX, B)).astype(np.int32)}))
    return params, rounds_in


def _run_jax(algorithm, nu_decay, params, rounds_in):
    jfed, _ = _configs(algorithm, nu_decay)
    algo = j_get_algorithm(algorithm, jfed)
    jp = jax.tree.map(jnp.asarray, params)
    spec = jflat.make_flat_spec(jp)
    fn = jax.jit(jflat.make_flat_cohort_round(
        spec, jsimple.lr_loss, algo, lr=LR, k_max=K_MAX, nu_decay=nu_decay))
    state = jrounds.init_state(jflat.ravel(spec, jp), M, algo)
    out = []
    for ids, cw, k, b in rounds_in:
        state, metrics = fn(state, jax.tree.map(jnp.asarray, b),
                            jnp.asarray(ids), jnp.asarray(k),
                            jnp.asarray(cw), jnp.float32(LAM))
        out.append((jax.tree.map(np.asarray, state),
                    jax.tree.map(np.asarray, metrics)))
    return out


def _run_port(algorithm, nu_decay, params, rounds_in, donate):
    _, fed = _configs(algorithm, nu_decay)
    algo = get_algorithm(algorithm, fed)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    fn = flat.make_flat_cohort_round(spec, simple.lr_loss, algo, lr=LR,
                                     k_max=K_MAX, nu_decay=nu_decay)
    state = rounds.init_state(flat.ravel(spec, tp), M, algo)
    out = []
    for ids, cw, k, b in rounds_in:
        state, metrics = fn(state, {kk: torch.from_numpy(v)
                                    for kk, v in b.items()},
                            torch.from_numpy(ids).long(),
                            torch.from_numpy(k), torch.from_numpy(cw), LAM,
                            donate=donate)
        out.append(({kk: v.clone() for kk, v in state.items()}, metrics))
    return out


def _assert_close(got, want):
    (gs, gm), (ws, wm) = got, want
    assert set(gs) == set(ws)
    assert int(gs["round"]) == int(ws["round"])
    np.testing.assert_allclose(gs["params"].numpy(), ws["params"],
                               **PARAMS_TOL)
    for key in ("nu", "nu_i"):
        if key in ws:
            np.testing.assert_allclose(gs[key].numpy(), ws[key], **NU_TOL,
                                       err_msg=key)
    for key in ("loss", "kbar", "mass"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   **PARAMS_TOL, err_msg=key)


@pytest.mark.parametrize("nu_decay", [0.0, 0.3])
@pytest.mark.parametrize("algorithm,sampler", [
    ("fedagrac", "uniform"), ("fedavg", "uniform"), ("fednova", "uniform"),
    ("scaffold", "uniform"), ("fedagrac", "weighted"),
    ("fedagrac", "availability")])
def test_flat_cohort_round_matches_jax(algorithm, sampler, nu_decay):
    params, rounds_in = _round_inputs(sampler)
    want = _run_jax(algorithm, nu_decay, params, rounds_in)
    got = _run_port(algorithm, nu_decay, params, rounds_in, donate=False)
    for g, w in zip(got, want):
        _assert_close(g, w)
    # the in-place update is the same computation
    donated = _run_port(algorithm, nu_decay, params, rounds_in, donate=True)
    for (gs, _), (ds, _) in zip(got, donated):
        for key in gs:
            assert torch.equal(gs[key], ds[key]), key


def test_cohort_round_leaves_a_kept_state_alone_and_donated_one_in_place():
    params, rounds_in = _round_inputs("uniform", n_rounds=1)
    _, fed = _configs("fedagrac", 0.3)
    algo = get_algorithm("fedagrac", fed)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    fn = flat.make_flat_cohort_round(spec, simple.lr_loss, algo, lr=LR,
                                     k_max=K_MAX, nu_decay=0.3)
    ids, cw, k, b = rounds_in[0]
    args = ({kk: torch.from_numpy(v) for kk, v in b.items()},
            torch.from_numpy(ids).long(), torch.from_numpy(k),
            torch.from_numpy(cw), LAM)
    state = rounds.init_state(flat.ravel(spec, tp), M, algo)
    state["nu_i"].normal_(generator=torch.Generator().manual_seed(0))
    before = state["nu_i"].clone()
    kept, _ = fn(state, *args)
    assert torch.equal(state["nu_i"], before)
    assert kept["nu_i"].data_ptr() != state["nu_i"].data_ptr()
    owned, _ = fn(state, *args, donate=True)
    assert owned["nu_i"].data_ptr() == state["nu_i"].data_ptr()
    assert torch.equal(owned["nu_i"], kept["nu_i"])


def test_cohort_round_refuses_unported_stages():
    """Robust aggregation (A10), payload attacks (A8) and compression (A9)
    on the cohort round are ported and build (their parity is
    tests/test_torch_robust.py's and tests/test_torch_async_compression.
    py's); the in-chunk scenario hook belongs to the device-sampled
    chunk: given without a device sampler it raises the reference's
    message, and with one it builds (its parity is
    tests/test_torch_device_mode.py's)."""
    from repro_torch.core import engine, robust
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.fed import scenarios
    _, fed = _configs("fedagrac", 0.0)
    algo = get_algorithm("fedagrac", fed)
    spec = flat.make_flat_spec({"w": torch.zeros(D, N_CLASSES)})
    fn = flat.make_flat_cohort_round(
        spec, simple.lr_loss, algo, lr=LR, k_max=K_MAX,
        compression=CompressionConfig(uplink="int8"),
        robust=robust.RobustConfig(defense="median", quarantine_window=2),
        attack=scenarios.sign_flip_scenario(M, rate=0.3))
    assert callable(fn)
    with pytest.raises(ValueError, match="in-scan \\(device-mode\\) hook"):
        engine.make_population_chunk(fn, 2,
                                     scenario_fn=lambda t, k, ids: k)
    assert callable(engine.make_population_chunk(
        fn, 2, cohort_fn=lambda t: None, sample_fn=lambda ts, ids: None,
        scenario_fn=lambda t, k, ids: k))


def test_population_chunk_equals_its_rounds():
    params, rounds_in = _round_inputs("uniform", n_rounds=3)
    _, fed = _configs("fedagrac", 0.3)
    algo = get_algorithm("fedagrac", fed)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    fn = flat.make_flat_cohort_round(spec, simple.lr_loss, algo, lr=LR,
                                     k_max=K_MAX, nu_decay=0.3)
    one = _run_port("fedagrac", 0.3, params, rounds_in, donate=False)
    stack = [torch.from_numpy(np.stack(a)) for a in zip(
        *[(ids, k, cw) for ids, cw, k, _ in rounds_in])]
    batches = {key: torch.from_numpy(np.stack([b[key] for *_, b in
                                               rounds_in]))
               for key in ("x", "y")}
    state = rounds.init_state(flat.ravel(spec, tp), M, algo)
    given = dict(state)
    chunk = engine.make_population_chunk(fn, 3, donate=True)
    out, metrics = chunk(given, batches, stack[0].long(), stack[1],
                         stack[2], [LAM] * 3)
    assert given == {}
    for key in out:
        assert torch.equal(out[key], one[-1][0][key]), key
    for key in ("loss", "kbar", "mass"):
        assert metrics[key].shape == (3,)
        assert torch.equal(metrics[key],
                           torch.stack([m[key] for _, m in one]))
    with pytest.raises(ValueError, match="3 rounds"):
        chunk(out, batches, stack[0][:2].long(), stack[1], stack[2],
              [LAM] * 2)


# ---------------------------------------------------------------------------
# the simulation's cohort path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def task():
    return fedprox_synthetic(0, 16, d=D, n_classes=N_CLASSES,
                             n_per_client=12)


def _sim(task, sampler, algorithm="fedagrac", nu_decay=0.0):
    data, parts = task
    fed = FedConfig(algorithm=algorithm, n_clients=16, lr=LR,
                    calibration_rate=LAM, weights="data",
                    param_layout="flat", cohort_size=4,
                    cohort_sampler=sampler, availability=0.6,
                    cohort_nu_decay=nu_decay, seed=3)
    ks = np.random.default_rng(1).integers(1, 5, (1, 16)).astype(np.int32)
    params = {"w": torch.zeros(D, N_CLASSES), "b": torch.zeros(N_CLASSES)}
    return FederatedSimulation(
        simple.lr_loss, params, fed,
        FederatedBatcher(data, parts, batch_size=5, seed=3, device="cpu"),
        k_schedule=ks, device="cpu")


@pytest.mark.parametrize("sampler,algorithm,nu_decay", [
    ("uniform", "fedagrac", 0.0), ("weighted", "fedagrac", 0.0),
    ("availability", "scaffold", 0.3), ("round_robin", "fednova", 0.3)])
def test_chunked_cohort_run_equals_per_round(task, sampler, algorithm,
                                             nu_decay):
    a = _sim(task, sampler, algorithm, nu_decay)
    b = _sim(task, sampler, algorithm, nu_decay)
    assert a._partial and a.population.sampler == sampler
    ha = a.run(6, chunk_rounds=1)
    hb = b.run(6, chunk_rounds=3)
    assert ha.loss == hb.loss and ha.kbar == hb.kbar and ha.mass == hb.mass
    assert len(ha.mass) == 6
    for key in a.state:
        assert torch.equal(a.state[key], b.state[key]), key
    assert ha.bytes_up == hb.bytes_up
    assert ha.bytes_up[0] == 4 * a._wire["uplink_per_client"]


def test_cohort_simulation_runs_the_reference_rounds(task):
    """The simulation's rounds are ``make_flat_cohort_round`` on the
    population's draws and the batcher's cohort batches, with the run's
    state updated in place."""
    sim = _sim(task, "uniform", nu_decay=0.3)
    hist = sim.run(2, chunk_rounds=2)
    ref = _sim(task, "uniform", nu_decay=0.3)
    fn = ref._pop_round_fn()
    state = ref.state
    for t in range(2):
        ids, cw = ref.population.host_cohort(t)
        state, m = fn(state, ref.batcher.cohort_batches(t, ids, ref.k_max),
                      torch.from_numpy(ids).long(),
                      torch.from_numpy(ref.k_schedule[0][ids]),
                      torch.from_numpy(cw), LAM)
        assert float(m["loss"]) == hist.loss[t]
    for key in state:
        assert torch.equal(state[key], sim.state[key]), key


def test_batcher_cohort_methods_bit_identical():
    from repro.data import FederatedBatcher as JBatcher
    from repro.data import fedprox_synthetic as j_synthetic
    key = jax.random.PRNGKey(0)
    jdata, jparts = j_synthetic(key, 10, d=6, n_classes=3, n_per_client=9)
    data, parts = fedprox_synthetic(
        int(jax.random.randint(key, (), 0, 2 ** 31 - 1)), 10, d=6,
        n_classes=3, n_per_client=9)
    jb = JBatcher(jdata, jparts, batch_size=4, seed=2)
    tb = FederatedBatcher(data, parts, batch_size=4, seed=2, device="cpu")
    cohorts = np.array([[3, 1, 7], [0, 9, 3]], np.int32)
    np.testing.assert_array_equal(tb.client_indices(4, 7, 3),
                                  jb.client_indices(4, 7, 3))
    one = tb.cohort_batches(5, cohorts[0], 3)
    want = jb.cohort_batches(5, cohorts[0], 3)
    chunk = tb.chunk_cohort_batches(5, cohorts, 3)
    jchunk = jb.chunk_cohort_batches(5, cohorts, 3)
    for k in ("x", "y"):
        np.testing.assert_array_equal(one[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(chunk[k].numpy(), np.asarray(jchunk[k]))
        assert torch.equal(chunk[k][0], one[k])
