"""The port's failure scenarios (``repro_torch.fed.scenarios``) against the
reference's on the CPU, with the reference's own keyed draws.

* Every builder of ``SCENARIOS`` made from the same ``FedConfig``: k′ rows,
  speed factors, latency extras (full rows and id subsets) and the
  availability profile over many rounds, bit for bit — ``diurnal``'s
  availability within ``scenarios.AVAIL_MAX_ULP`` (XLA's float32 cos is
  not correctly rounded); ``round_time`` equal.
* The corrupt sets of several (M, seed, rate), equal; at (M = 8, seed 0,
  rate 0.25) the set is EMPTY under jax 0.9.0's threefry, the reason the
  reference's ``nan_inject`` tests at that rate see no attacker (ROADMAP
  C2), and at rate 0.3 it is {7} for M = 8 and M = 10.
* ``corrupt_delta`` / ``corrupt_nu`` on seeded rows at cohort ids for each
  attack: NaN/Inf/scale/sign rows bit for bit, ``garbage``'s within a few
  float32 ulp (its noise is ``keyed.normal``; its norms sum in another
  order), with and without host noise rows given.
* ``simulate_timeline`` under ``dropout`` (with rejoin), ``spike``,
  ``flaky`` and ``diurnal`` (an ``availability`` population) equal to the
  reference's, array for array; a ``trace_scenario`` built from the same
  tables equal; ``trace`` from a config and unknown names refused with the
  reference's messages.
"""
import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.fed import clock as jclock  # noqa: E402
from repro.fed import population as jpop  # noqa: E402
from repro.fed import scenarios as jscn  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.fed import clock as tclock  # noqa: E402
from repro_torch.fed import population as tpop  # noqa: E402
from repro_torch.fed import scenarios as scn  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M = 10
KNOBS = {"dropout": dict(dropout_rate=0.3, rejoin_delay=2.0),
         "spike": dict(scenario_rate=0.4, scenario_magnitude=8.0),
         "flaky": dict(scenario_rate=0.3, scenario_magnitude=5.0),
         "diurnal": dict(scenario_period=16.0),
         "nan_inject": dict(scenario_rate=0.3),
         "inf_inject": dict(scenario_rate=0.3),
         "scale_attack": dict(scenario_rate=0.3, scenario_magnitude=25.0),
         "sign_flip": dict(scenario_rate=0.3),
         "garbage": dict(scenario_rate=0.3, scenario_magnitude=10.0)}
ATTACKS = ("nan_inject", "inf_inject", "scale_attack", "sign_flip",
           "garbage")


def _pair(name, m=M, seed=3):
    kw = dict(n_clients=m, seed=seed, scenario=name, **KNOBS.get(name, {}))
    return (jscn.make_scenario(JFedConfig(**kw)),
            scn.make_scenario(FedConfig(**kw)))


def _ulp(a, b) -> int:
    a, b = (np.asarray(x, np.float32) for x in (a, b))
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _k_schedule(rounds=60, m=M, seed=0):
    return np.random.default_rng(seed).integers(
        1, 41, (rounds, m)).astype(np.int32)


def test_registry_names_are_the_reference_names():
    assert sorted(scn.SCENARIOS) == sorted(jscn.SCENARIOS)
    assert _pair("baseline") == (None, None)


@pytest.mark.parametrize("name", sorted(set(jscn.SCENARIOS)
                                        - {"baseline", "trace"}))
def test_timing_hooks_bit_equal(name):
    js, ts = _pair(name)
    assert (ts.perturbs_k, ts.corrupts_payload, ts.rejoin_delay) == \
        (js.perturbs_k, js.corrupts_payload, js.rejoin_delay)
    assert (ts.availability_fn is None) == (js.availability_fn is None)
    ks = _k_schedule()
    clock = jclock.make_clock(M, dist="lognormal", sigma=1.0, seed=7)
    ids = np.array([7, 2, 9, 2], np.int32)
    for t in range(40):
        k = ts.host_k_eff(t, ks[t])
        assert k.dtype == np.int32
        assert np.array_equal(np.asarray(js.host_k_eff(t, ks[t])), k)
        assert np.array_equal(js.host_speed_factor(t),
                              ts.host_speed_factor(t))
        assert np.array_equal(js.host_latency_extra(t),
                              ts.host_latency_extra(t))
        # an id subset (repeats included) is the full row at those ids
        assert np.array_equal(
            np.asarray(js.k_eff(t, ks[t][ids], ids=ids)),
            ts.k_eff(t, ks[t][ids], ids=ids))
        assert np.array_equal(ts.k_eff(t, ks[t][ids], ids=ids), k[ids])
        assert ts.round_time(clock, t, ks[t]) == \
            js.round_time(clock, t, ks[t])
        if name == "diurnal":
            assert _ulp(js.host_avail(t), ts.host_avail(t)) <= \
                scn.AVAIL_MAX_ULP
        else:
            assert np.array_equal(js.host_avail(t), ts.host_avail(t))
    if name == "dropout":
        # K = 1 clients cannot abort; every k′ in [1, K]
        ones = np.ones(M, np.int32)
        assert np.array_equal(ts.host_k_eff(3, ones), ones)
        assert all((ts.host_k_eff(t, ks[t]) >= 1).all() for t in range(40))


@pytest.mark.parametrize("m,period", [(10, 64.0), (101, 64.0), (7, 10.0)])
def test_diurnal_availability_within_an_ulp(m, period):
    js = jscn.diurnal_scenario(m, period=period)
    ts = scn.diurnal_scenario(m, period=period)
    for t in range(0, 400, 3):
        a = ts.host_avail(t)
        assert _ulp(js.host_avail(t), a) <= scn.AVAIL_MAX_ULP
        assert ((a > 0) & (a <= 1)).all()


@pytest.mark.parametrize("m,seed,rate", [(8, 0, 0.25), (8, 0, 0.3),
                                         (10, 0, 0.3), (10, 3, 0.3),
                                         (100, 5, 0.1), (1000, 1, 0.2)])
def test_corrupt_sets_equal(m, seed, rate):
    want = np.asarray(jscn._corrupt_set(m, seed, rate))
    got = scn._corrupt_set(m, seed, rate)
    assert got.dtype == bool and np.array_equal(got, want)


def test_the_reference_c2_trap_is_an_empty_corrupt_set():
    """Under jax 0.9.0's threefry nan_inject at rate 0.25 over 8 clients
    corrupts nobody; at 0.3 it corrupts client 7 (M = 8 and M = 10)."""
    assert not np.asarray(jscn._corrupt_set(8, 0, 0.25)).any()
    assert not scn._corrupt_set(8, 0, 0.25).any()
    assert np.flatnonzero(scn._corrupt_set(8, 0, 0.3)).tolist() == [7]
    assert np.flatnonzero(scn._corrupt_set(10, 0, 0.3)).tolist() == [7]


@pytest.mark.parametrize("name", ATTACKS)
@pytest.mark.parametrize("noise_given", [False, True])
def test_corrupt_rows_match_reference(name, noise_given):
    js, ts = _pair(name, seed=0)
    rng = np.random.default_rng(4)
    p, n = 640, 610
    rows = rng.standard_normal((6, p)).astype(np.float32)
    rows[:, n:] = 0.0
    ids = np.array([7, 1, 7, 4, 0, 9], np.int32)
    assert ts.hit[ids].any() and not ts.hit[ids].all()
    for t in (0, 5):
        for tag, jfn, tfn in ((0, js.corrupt_delta, ts.corrupt_delta),
                              (1, js.corrupt_nu, ts.corrupt_nu)):
            want = np.asarray(jfn(jnp.int32(t), jnp.asarray(rows), n,
                                  ids=jnp.asarray(ids)))
            noise = None
            if noise_given and ts.needs_noise:
                noise = torch.from_numpy(ts.payload_noise(t, ids, p)[tag])
            got = tfn(torch.tensor(t, dtype=torch.int32),
                      torch.from_numpy(rows),
                      n, ids=torch.from_numpy(ids.astype(np.int64)),
                      noise=noise).numpy()
            assert np.array_equal(np.isfinite(got), np.isfinite(want))
            fin = np.isfinite(want)
            if name == "garbage":
                np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6,
                                           atol=2e-6)
                # honest rows pass through untouched
                honest = ~ts.hit[ids]
                assert np.array_equal(got[honest], rows[honest])
            else:
                assert np.array_equal(got[fin], want[fin])
            assert np.array_equal(got[:, n:][~np.isnan(got[:, n:])],
                                  want[:, n:][~np.isnan(want[:, n:])])


def test_payload_noise_is_none_without_noise_and_zero_for_honest_rows():
    ts = _pair("scale_attack")[1]
    assert ts.payload_noise(0, None, 640) is None
    g = _pair("garbage", seed=0)[1]
    noise = g.payload_noise(3, np.arange(M), 640)
    assert noise.shape == (2, M, 640) and noise.dtype == np.float32
    assert not noise[:, ~g.hit].any() and noise[:, g.hit].all()
    assert not np.array_equal(noise[0], noise[1])


def _timelines(name, population):
    js, ts = _pair(name, seed=1)
    ks = _k_schedule(400, seed=2)
    kw = dict(dist="lognormal", sigma=1.0, seed=7)
    jpopn = tpopn = None
    if population:
        jpopn = jpop.ClientPopulation(M, cohort_size=8,
                                      sampler="availability", seed=1)
        tpopn = tpop.ClientPopulation(M, cohort_size=8,
                                      sampler="availability", seed=1)
        jpopn.availability_fn = js.availability_fn
        tpopn.availability_fn = ts.availability_fn
    buffer = 5
    a = jclock.simulate_timeline(ks, jclock.make_clock(M, **kw), buffer, 60,
                                 population=jpopn, scenario=js)
    b = tclock.simulate_timeline(ks, tclock.make_clock(M, **kw), buffer, 60,
                                 population=tpopn, scenario=ts)
    return a, b


@pytest.mark.parametrize("name,population", [
    ("dropout", False), ("spike", False), ("flaky", False),
    ("diurnal", True), ("dropout", True)])
def test_timeline_equals_reference(name, population):
    a, b = _timelines(name, population)
    for field in ("ids", "versions", "waves", "k_steps", "staleness",
                  "arrival_t", "fresh", "dispatch_ids", "k_sched",
                  "aborted"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    if name == "dropout":
        assert b.aborted.any() and (b.k_steps <= b.k_sched).all()
    if name in ("flaky", "diurnal"):
        assert not b.aborted.any()


def test_trace_scenario_from_tables_and_refused_from_config():
    rng = np.random.default_rng(0)
    speeds = rng.uniform(0.5, 2.0, (4, M)).astype(np.float32)
    lat = rng.uniform(0.0, 1.0, (4, M)).astype(np.float32)
    av = rng.uniform(0.1, 1.0, (4, M)).astype(np.float32)
    js = jscn.trace_scenario(speeds, latency_extras=lat, avail=av)
    ts = scn.trace_scenario(speeds, latency_extras=lat, avail=av)
    for t in range(9):
        assert np.array_equal(js.host_speed_factor(t),
                              ts.host_speed_factor(t))
        assert np.array_equal(js.host_latency_extra(t),
                              ts.host_latency_extra(t))
        assert np.array_equal(js.host_avail(t), ts.host_avail(t))
    with pytest.raises(ValueError, match="scenario='trace' needs explicit"):
        scn.make_scenario(FedConfig(n_clients=M, scenario="trace"))
    bad = types.SimpleNamespace(scenario="bogus", n_clients=M)
    with pytest.raises(ValueError) as jinfo:
        jscn.make_scenario(bad)
    with pytest.raises(ValueError) as tinfo:
        scn.make_scenario(bad)
    assert str(tinfo.value) == str(jinfo.value)
    for builder, kw in ((scn.dropout_scenario, dict(rate=1.5)),
                        (scn.spike_scenario, dict(magnitude=0.5)),
                        (scn.diurnal_scenario, dict(period=0.0)),
                        (scn.scale_attack_scenario, dict(magnitude=0.0)),
                        (scn.garbage_scenario, dict(magnitude=-1.0)),
                        (scn.nan_inject_scenario, dict(rate=-0.1))):
        jb = getattr(jscn, builder.__name__)
        with pytest.raises(ValueError) as jinfo:
            jb(M, **kw)
        with pytest.raises(ValueError) as tinfo:
            builder(M, **kw)
        assert str(tinfo.value) == str(jinfo.value)


@pytest.mark.parametrize("kw", [{"scenario": "bogus"}, {"defense": "bogus"},
                                {"trim_frac": 0.5}, {"krum_f": -1},
                                {"quarantine_window": -1},
                                {"quarantine_z": 0.0}])
def test_config_refusals_match_reference(kw):
    with pytest.raises(ValueError) as jinfo:
        JFedConfig(**kw)
    with pytest.raises(ValueError) as tinfo:
        FedConfig(**kw)
    assert str(tinfo.value) == str(jinfo.value)
