"""The buffered engine under failure scenarios and payload attacks in the
port, against the JAX package on the CPU.

* ``BufferedAsyncSimulation`` under each attack × {none, clip, median,
  trimmed_mean, krum} with a quarantine, on a lognormal clock whose buffers
  hold a client twice (its counters add once per report, its EWMA and
  quarantine rows keep the last report's): loss, K̄, mass, params, ν, ν⁽ⁱ⁾
  and the health vectors within tests/test_torch_round.py's tolerances,
  ``History.quarantined`` equal; attacks also on the int8 and top-k wire.
* Each defense without a quarantine; a ``trace_scenario`` passed in.
* Under ``dropout`` (with rejoin), ``spike``, ``flaky`` and ``diurnal``
  (an ``availability`` population), the report weights scaled by k′/K:
  ``History.dropped``, sim_time, staleness and mass equal to the
  reference's, loss and params within tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.fed import scenarios as jscn  # noqa: E402
from repro_torch.fed import clock, scenarios  # noqa: E402
from test_torch_async import M, PARAMS_TOL, _assert_runs_close  # noqa: E402
from test_torch_async import _engines, _has_repeats  # noqa: E402
from test_torch_robust import ATTACKS, DEFENSES  # noqa: E402
from test_torch_robust import _assert_states_close  # noqa: E402

# clients 2 and 5 of the 6 are corrupt at rate 0.3 under seed 2
SEED, RATE, T_UPDATES = 2, 0.3, 8


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


def _run(kw, t_updates=T_UPDATES, jscenario=None, tscenario=None,
         **engine_kw):
    jsim, tsim = _engines(dict(dict(algorithm="fedagrac", buffer_size=3,
                                    seed=SEED), **kw), **engine_kw)
    if tscenario is not None:
        # an explicit scenario object, as the engines' ``scenario=`` takes
        jsim.scenario, tsim.scenario = jscenario, tscenario
    assert _has_repeats(tsim, t_updates)
    jh, th = jsim.run(t_updates), tsim.run(t_updates)
    return jsim, jh, tsim, th


@pytest.mark.parametrize("defense", DEFENSES)
@pytest.mark.parametrize("attack", ATTACKS)
def test_defended_buffered_run_matches_reference(attack, defense):
    assert scenarios._corrupt_set(M, SEED, RATE).any()
    jsim, jh, tsim, th = _run(dict(
        scenario=attack, scenario_rate=RATE, scenario_magnitude=5.0,
        defense=defense, quarantine_window=3, quarantine_z=1.0))
    assert th.quarantined == jh.quarantined
    assert len(th.quarantined) == T_UPDATES
    for key in ("loss", "kbar", "mass"):
        got, want = np.array(getattr(th, key)), np.array(getattr(jh, key))
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin), key
        np.testing.assert_allclose(got[fin], want[fin], **PARAMS_TOL)
    _assert_states_close(dict(tsim.state), jax.tree.map(np.asarray,
                                                        jsim.state))


@pytest.mark.parametrize("comp", ["int8", "topk"])
@pytest.mark.parametrize("attack", ["nan_inject", "scale_attack"])
def test_attacks_on_the_buffered_wire_match_reference(attack, comp):
    jsim, jh, tsim, th = _run(dict(
        scenario=attack, scenario_rate=RATE, scenario_magnitude=5.0,
        defense="median", quarantine_window=3, compressor=comp,
        broadcast_compressor="int8"))
    assert th.quarantined == jh.quarantined
    _assert_states_close(dict(tsim.state), jax.tree.map(np.asarray,
                                                        jsim.state))


@pytest.mark.parametrize("name", ["dropout", "spike", "flaky", "diurnal"])
def test_timing_scenarios_on_the_buffered_engine_match_reference(name):
    kw = dict(scenario=name, dropout_rate=0.4, rejoin_delay=1.5,
              scenario_rate=0.5, scenario_magnitude=4.0,
              scenario_period=8.0)
    if name == "diurnal":
        kw.update(cohort_size=4, cohort_sampler="availability",
                  buffer_size=3)
    jsim, jh, tsim, th = _run(kw, t_updates=12)
    _assert_runs_close(jsim, jh, tsim, th)
    assert th.dropped == jh.dropped and len(th.dropped) == 12
    if name in ("dropout", "spike"):
        assert any(d > 0 for d in th.dropped)
    tl = clock.simulate_timeline(tsim.k_schedule, tsim.clock, tsim.buffer,
                                 12, population=tsim.population,
                                 scenario=tsim.scenario)
    assert th.dropped == tl.aborted.mean(axis=1).tolist()


@pytest.mark.parametrize("defense", DEFENSES[1:])
def test_defense_without_quarantine_on_the_buffered_engine(defense):
    jsim, jh, tsim, th = _run(dict(scenario="scale_attack",
                                   scenario_rate=RATE,
                                   scenario_magnitude=5.0, defense=defense))
    assert th.quarantined == jh.quarantined == [0.0] * T_UPDATES
    assert not any(k.startswith("hz_") for k in tsim.state)
    _assert_states_close(dict(tsim.state), jax.tree.map(np.asarray,
                                                        jsim.state))


def test_trace_scenario_on_the_buffered_engine_matches_reference():
    """A ``trace_scenario`` (tables a config cannot carry) passed to both
    engines: the same timeline and run."""
    rng = np.random.default_rng(3)
    speeds = rng.uniform(0.3, 2.0, (5, M)).astype(np.float32)
    lat = rng.uniform(0.0, 1.5, (5, M)).astype(np.float32)
    jsim, jh, tsim, th = _run(
        {}, t_updates=12,
        jscenario=jscn.trace_scenario(speeds, latency_extras=lat),
        tscenario=scenarios.trace_scenario(speeds, latency_extras=lat))
    _assert_runs_close(jsim, jh, tsim, th)
    assert th.dropped == jh.dropped == [0.0] * 12
