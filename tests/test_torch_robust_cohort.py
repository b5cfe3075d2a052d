"""The attacked, defended cohort round and the synchronous simulation under
failure scenarios in the port, against the JAX package on the CPU.

* ``make_flat_cohort_round`` under each attack × {none, clip, median,
  trimmed_mean, krum} with a quarantine, over 4 rounds whose third cohort
  draws a client twice, fed the same cohorts, K and weights as the
  reference's: params, ν, ν⁽ⁱ⁾ and the health vectors within
  tests/test_torch_round.py's tolerances (integer and finiteness patterns
  equal), the ``quarantined`` metric equal.  With ``donate=True`` (every
  other defense) the ν⁽ⁱ⁾ and health stores are the state's own tensors,
  updated in place, and hold what the copying round computes.
* ``FederatedSimulation`` under ``dropout``, ``spike``, ``flaky`` and
  ``diurnal`` (an ``availability`` cohort; full
  participation and a uniform cohort — each package drawing its own
  cohorts, asserted equal — chunked and per round) and under a defended
  ``nan_inject`` run (8 rounds: the cohorts of seed 2 first re-draw a
  quarantined client in round 6): ``History.dropped``,
  ``History.quarantined``, K̄ and mass equal to the reference's, loss and
  params within tolerance; ``garbage``'s host noise rows shipped with a
  chunk give the per-round run, bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import robust as jrobust  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import Dataset as JDataset  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.fed import scenarios as jscn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import flat, robust, rounds, stages  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.data import Dataset, FederatedBatcher  # noqa: E402
from repro_torch.fed import FederatedSimulation, scenarios  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from test_torch_robust import ATTACKS, DEFENSES, PARAMS_TOL  # noqa: E402
from test_torch_robust import _assert_states_close  # noqa: E402

PM, C, B, D, N_CLASSES, K_MAX = 10, 5, 5, 8, 4, 3
LR, LAM = 0.05, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort_inputs():
    rng = np.random.default_rng(1)
    params = {"w": (0.5 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": (0.5 * rng.standard_normal(N_CLASSES)).astype(np.float32)}
    k_row = rng.integers(1, K_MAX + 1, PM).astype(np.int32)
    rounds_in = []
    for t in range(4):
        ids = rng.permutation(PM)[:C].astype(np.int32)
        if t == 2:
            ids = np.array([7, 3, 7, 1, 2], np.int32)     # a repeated id
        cw = (0.1 + 0.3 * rng.random(C)).astype(np.float32)
        rounds_in.append((ids, cw, k_row[ids], {
            "x": rng.standard_normal((C, K_MAX, B, D)).astype(np.float32),
            "y": rng.integers(0, N_CLASSES, (C, K_MAX, B)).astype(
                np.int32)}))
    return params, rounds_in


@pytest.mark.parametrize("defense", DEFENSES)
@pytest.mark.parametrize("attack", ATTACKS)
def test_defended_cohort_round_matches_reference(attack, defense,
                                                 cohort_inputs):
    params, rounds_in = cohort_inputs
    donate = DEFENSES.index(defense) % 2 == 1
    kw = dict(algorithm="fedagrac", n_clients=PM, lr=LR,
              calibration_rate=LAM, param_layout="flat", cohort_size=C,
              scenario=attack, scenario_rate=0.3, scenario_magnitude=5.0,
              defense=defense, quarantine_window=3, quarantine_z=0.5)
    jfed, fed = JFedConfig(**kw), FedConfig(**kw)
    jalgo, algo = (j_get_algorithm("fedagrac", jfed),
                   get_algorithm("fedagrac", fed))
    jp = jax.tree.map(jnp.asarray, params)
    jspec = jflat.make_flat_spec(jp)
    jrb = jrobust.RobustConfig.from_fed(jfed)
    jfn = jax.jit(jflat.make_flat_cohort_round(
        jspec, jsimple.lr_loss, jalgo, lr=LR, k_max=K_MAX, robust=jrb,
        attack=jscn.make_scenario(jfed)))
    js = jrounds.init_state(jflat.ravel(jspec, jp), PM, jalgo, spec=jspec,
                            robust=jrb)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    rb = robust.RobustConfig.from_fed(fed)
    atk = scenarios.make_scenario(fed)
    assert atk.hit[np.concatenate([r[0] for r in rounds_in])].any()
    tfn = flat.make_flat_cohort_round(spec, simple.lr_loss, algo, lr=LR,
                                      k_max=K_MAX, robust=rb, attack=atk)
    ts = rounds.init_state(flat.ravel(spec, tp), PM, algo, spec=spec,
                           robust=rb)
    stores = {k: ts[k] for k in ("nu_i",) + robust.ROBUST_STATE_KEYS}
    for ids, cw, k, b in rounds_in:
        js, jm = jfn(js, jax.tree.map(jnp.asarray, b), jnp.asarray(ids),
                     jnp.asarray(k), jnp.asarray(cw), jnp.float32(LAM))
        last = stages.last_occurrence(ids)
        last = (None if np.array_equal(last, np.arange(C))
                else torch.from_numpy(last))
        ts, tm = tfn(ts, {kk: torch.from_numpy(v) for kk, v in b.items()},
                     torch.from_numpy(ids.astype(np.int64)),
                     torch.from_numpy(k), torch.from_numpy(cw), LAM,
                     donate=donate, last=last)
        assert float(tm["quarantined"]) == float(jm["quarantined"])
    _assert_states_close(ts, jax.tree.map(np.asarray, js))
    for key, t in stores.items():
        assert (ts[key] is t) == donate, key


# ---------------------------------------------------------------------------
# the synchronous simulation under failure scenarios
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_task():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, D)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, 300).astype(np.int32)
    parts = np.array_split(rng.permutation(300), PM)
    params = {"w": (0.3 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": np.zeros(N_CLASSES, np.float32)}
    ks = rng.integers(1, 7, (20, PM)).astype(np.int32)
    return x, y, parts, params, ks


def _sims(task, kw):
    x, y, parts, params, ks = task
    kw = dict(dict(algorithm="fedagrac", n_clients=PM, lr=LR,
                   calibration_rate=LAM, weights="data",
                   param_layout="flat"), **kw)
    jsim = JSimulation(
        jsimple.lr_loss, jax.tree.map(jnp.asarray, params),
        JFedConfig(**kw),
        JBatcher(JDataset(jnp.asarray(x), jnp.asarray(y)), parts,
                 batch_size=B), k_schedule=ks)
    tsim = FederatedSimulation(
        simple.lr_loss, {k: torch.from_numpy(v) for k, v in params.items()},
        FedConfig(**kw),
        FederatedBatcher(Dataset(torch.from_numpy(x),
                                 torch.from_numpy(y).long()), parts,
                         batch_size=B, device="cpu"),
        k_schedule=ks, device="cpu")
    if tsim._partial:
        # the port draws the reference's keyed cohorts: nothing is fed
        for t in range(8):
            np.testing.assert_array_equal(
                tsim.population.host_cohort(t)[0],
                np.asarray(jsim.population.host_cohort(t)[0]))
    return jsim, tsim


@pytest.mark.parametrize("name,cohort,chunk", [
    ("dropout", 0, 3), ("dropout", 4, 1), ("spike", 0, 1), ("spike", 4, 3),
    ("flaky", 0, 3), ("diurnal", 4, 3)])
def test_scenario_sync_runs_match_reference(name, cohort, chunk, sim_task):
    kw = dict(scenario=name, dropout_rate=0.4, scenario_rate=0.5,
              scenario_magnitude=3.0, cohort_size=cohort, seed=1)
    if name == "diurnal":
        kw.update(cohort_sampler="availability", scenario_period=8.0)
    jsim, tsim = _sims(sim_task, kw)
    jh = jsim.run(6, eval_every=6, chunk_rounds=chunk)
    th = tsim.run(6, eval_every=6, chunk_rounds=chunk)
    assert th.dropped == jh.dropped and len(th.dropped) == 6
    if name in ("dropout", "spike"):
        assert any(d > 0 for d in th.dropped)
    if name == "diurnal":
        # the scenario's hook drives the port's availability draw
        assert tsim.population.availability_fn is not None
    assert th.kbar == pytest.approx(jh.kbar, rel=1e-6)
    assert th.mass == pytest.approx(jh.mass, rel=1e-6)
    np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)
    np.testing.assert_allclose(tsim.state["params"].numpy(),
                               np.asarray(jsim.state["params"]),
                               **PARAMS_TOL)


@pytest.mark.parametrize("cohort", [0, 4])
def test_defended_sync_runs_record_quarantines_as_reference(cohort,
                                                            sim_task):
    kw = dict(scenario="nan_inject", scenario_rate=0.3, cohort_size=cohort,
              defense="median", quarantine_window=2, seed=2)
    assert scenarios._corrupt_set(PM, 2, 0.3).any()
    jsim, tsim = _sims(sim_task, kw)
    # 8 rounds: the reference's cohorts of seed 2 first re-draw a
    # quarantined client in round 6
    jh, th = jsim.run(8, eval_every=4), tsim.run(8, eval_every=4)
    assert th.quarantined == jh.quarantined and sum(th.quarantined) > 0
    assert th.dropped == jh.dropped == [0.0] * 8
    np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)
    _assert_states_close({k: v for k, v in tsim.state.items()},
                         jax.tree.map(np.asarray, jsim.state))


@pytest.mark.parametrize("cohort", [0, 4])
def test_garbage_chunk_noise_equals_per_round_draws(cohort, sim_task):
    kw = dict(scenario="garbage", scenario_rate=0.3, cohort_size=cohort,
              defense="krum", quarantine_window=2, seed=2)
    a, b = (_sims(sim_task, kw)[1] for _ in range(2))
    a.run(4, chunk_rounds=1)
    a.run(2, chunk_rounds=2)        # a second run: keys follow the state
    b.run(4, chunk_rounds=4)
    b.run(2, chunk_rounds=1)
    for key in a.state:
        assert torch.equal(a.state[key], b.state[key]), key
    # against the reference, at the float tolerance
    jsim = _sims(sim_task, kw)[0]
    jsim.run(4, chunk_rounds=4)
    jsim.run(2, chunk_rounds=2)
    _assert_states_close(dict(a.state), jax.tree.map(np.asarray,
                                                     jsim.state))
