"""The port's device mode (data.DeviceBatcher, core/engine.py's device
chunks, the simulation's and the buffered engine's device-sampler paths)
against the JAX package on the CPU, with nothing fed across: both packages
draw their own cohorts, k′ rows and batches from the same seeds.

* A device-sampled synchronous run (fedagrac, fedavg, fednova; per round
  and in chunks of 3): loss, K̄ and params within
  tests/test_torch_round.py's tolerances.
* The device-mode cohort chunk under ``dropout`` through the in-chunk
  ``scenario_fn``, for each partial sampler: ``History.dropped`` and mass
  equal to the reference's, loss and state within tolerance, and the
  chunked run equal to the per-round run, bit for bit.
* A buffered run on the device batcher (full participation and a uniform
  cohort): loss, K̄, mass and params within tolerance.
* ``benchmarks.common.make_task(sampler="device")`` through ``run_sim``:
  the reference's accuracies to the printed digit.
* The ``failure_scenarios`` example twin (on the device batcher): its rows
  equal the reference example's, carried in ``reference_quick.json``
  (one cell regenerated from the reference here), and the committed
  cohorts the card is held to are the port's draws.
* The device chunks' argument checks raise the reference's messages.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.data import DeviceBatcher as JDeviceBatcher  # noqa: E402
from repro.data.synthetic import Dataset as JDataset  # noqa: E402
from repro.fed import BufferedAsyncSimulation as JAsync  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import Dataset, DeviceBatcher  # noqa: E402
from repro_torch.fed import (BufferedAsyncSimulation,  # noqa: E402
                             FederatedSimulation)
from repro_torch.models import simple  # noqa: E402

PM, B, D, N_CLASSES = 10, 5, 8, 4
LR, LAM = 0.05, 0.5
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def task():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, D)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, 300).astype(np.int32)
    sizes = rng.integers(10, 50, PM)
    cuts = np.cumsum(sizes)[:-1] * 300 // sizes.sum()
    parts = np.split(rng.permutation(300), cuts)
    params = {"w": (0.3 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": np.zeros(N_CLASSES, np.float32)}
    ks = rng.integers(1, 5, (20, PM)).astype(np.int32)
    return x, y, parts, params, ks


def _batchers(task, seed=1):
    x, y, parts, _, _ = task
    jb = JDeviceBatcher(JDataset(jnp.asarray(x), jnp.asarray(y)), parts,
                        batch_size=B, seed=seed)
    tb = DeviceBatcher(Dataset(torch.from_numpy(x),
                               torch.from_numpy(y).long()), parts,
                       batch_size=B, seed=seed, device="cpu")
    return jb, tb


def _kw(**kw):
    return dict(dict(algorithm="fedagrac", n_clients=PM, lr=LR,
                     calibration_rate=LAM, weights="data",
                     param_layout="flat"), **kw)


def _sims(task, kw, engine_cls=(JSimulation, FederatedSimulation)):
    _, _, _, params, ks = task
    jb, tb = _batchers(task)
    jsim = engine_cls[0](jsimple.lr_loss,
                         jax.tree.map(jnp.asarray, params),
                         JFedConfig(**kw), jb, k_schedule=ks)
    tsim = engine_cls[1](simple.lr_loss,
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         FedConfig(**kw), tb, k_schedule=ks, device="cpu")
    return jsim, tsim


def _close_states(tsim, jsim):
    for key, want in jsim.state.items():
        got = tsim.state[key]
        tol = NU_TOL if key.startswith("nu") else PARAMS_TOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=key)


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("algorithm", ["fedagrac", "fedavg", "fednova"])
def test_device_sampled_sync_run_matches_reference(algorithm, chunk, task):
    jsim, tsim = _sims(task, _kw(algorithm=algorithm))
    assert tsim._device_sampler
    jh = jsim.run(6, chunk_rounds=chunk)
    th = tsim.run(6, chunk_rounds=chunk)
    assert th.kbar == pytest.approx(jh.kbar, rel=1e-6)
    np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)
    _close_states(tsim, jsim)


@pytest.mark.parametrize("sampler", ["uniform", "weighted", "availability",
                                     "round_robin"])
def test_device_cohort_chunk_with_scenario_fn_matches_reference(sampler,
                                                                task):
    kw = _kw(cohort_size=4, cohort_sampler=sampler, availability=0.6,
             scenario="dropout", dropout_rate=0.4, seed=2)
    jsim, tsim = _sims(task, kw)
    for t in range(6):
        np.testing.assert_array_equal(
            tsim.population.host_cohort(t)[0],
            np.asarray(jsim.population.host_cohort(t)[0]))
    jh = jsim.run(6, chunk_rounds=3)
    th = tsim.run(6, chunk_rounds=3)
    assert th.dropped == jh.dropped and any(d > 0 for d in th.dropped)
    assert th.mass == pytest.approx(jh.mass, rel=1e-6)
    np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)
    _close_states(tsim, jsim)
    per_round = _sims(task, kw)[1]
    ph = per_round.run(6, chunk_rounds=1)
    assert ph.loss == th.loss and ph.mass == th.mass
    for key in tsim.state:
        assert torch.equal(per_round.state[key], tsim.state[key]), key


@pytest.mark.parametrize("cohort", [0, 4])
def test_buffered_run_on_device_batcher_matches_reference(cohort, task):
    kw = _kw(buffer_size=4 if cohort else 6, cohort_size=cohort,
             staleness="hinge", speed_dist="lognormal", speed_sigma=1.0,
             seed=3)
    jsim, tsim = _sims(task, kw, (JAsync, BufferedAsyncSimulation))
    assert tsim._device_sampler
    jh = jsim.run(8, chunk_updates=4)
    th = tsim.run(8, chunk_updates=4)
    assert th.kbar == pytest.approx(jh.kbar, rel=1e-6)
    assert th.mass == pytest.approx(jh.mass, rel=1e-6)
    np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)
    np.testing.assert_allclose(tsim.state["params"].numpy(),
                               np.asarray(jsim.state["params"]),
                               **PARAMS_TOL)


def test_make_task_device_sampler_rows_equal_reference():
    from benchmarks import common as jcommon
    from repro_torch.benchmarks import common
    jt = jcommon.make_task("lr", noniid=True, sampler="device")
    tt = common.make_task("lr", noniid=True, sampler="device",
                          device="cpu")
    assert isinstance(tt.batcher, DeviceBatcher)
    jh = jcommon.run_sim(jt, "fedagrac", 3, k_mean=5, eval_every=3)
    th = common.run_sim(tt, "fedagrac", 3, k_mean=5, eval_every=3)
    assert [f"{v:.4f}" for v in th.metric] == [
        f"{v:.4f}" for v in jh.metric]
    np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)


def test_device_chunk_checks_raise_reference_messages():
    fn = lambda *a, **k: None                                # noqa: E731
    cases = [dict(cohort_fn=fn), dict(sample_fn=fn),
             dict(scenario_fn=fn)]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jengine.make_population_chunk(fn, 2, **kw)
        with pytest.raises(ValueError) as got:
            engine.make_population_chunk(fn, 2, **kw)
        assert str(got.value) == str(want.value)


ROOT = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((ROOT / "src" / "repro_torch" / "benchmarks"
                        / "reference_quick.json").read_text())


def test_failure_scenarios_twin_rows_equal_reference(monkeypatch, capsys):
    """The twin's table is the committed reference table; the reference
    example's own FedaGrac run at the highest rate, regenerated here (its
    whole table takes ~25 s), is that table's cell."""
    import importlib.util
    from repro_torch.examples import failure_scenarios
    ref = REFERENCE["examples"]["failure_scenarios"]
    assert failure_scenarios.run("cpu") == ref["rows"]
    spec = importlib.util.spec_from_file_location(
        "reference_failure_scenarios", ROOT / "examples" /
        "failure_scenarios.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "ALGORITHMS", ("fedagrac",))
    monkeypatch.setattr(mod, "RATES", (0.6,))
    capsys.readouterr()
    mod.main()
    row = capsys.readouterr().out.split("\n\n")[0].splitlines()[1].split()
    want = next(r for r in ref["rows"] if r[0] == "fedagrac")
    assert row == [want[0], want[3], want[4]]


def test_committed_cohorts_are_the_port_draws():
    """``reference_quick.json``'s cohorts (tests/_reference_quick.py's
    ``cohort_rows``, drawn by the reference) are the port's draws of the
    same settings, which chip_smoke.py holds the card to."""
    from repro_torch.examples import partial_participation as pp
    from repro_torch.fed import ClientPopulation
    _, parts = pp.task()
    sizes = np.array([len(p) for p in parts], np.float64)
    for rec in REFERENCE["cohorts"]:
        weights = (sizes / sizes.sum()
                   if rec["setting"] == "partial_participation" else None)
        pop = ClientPopulation(rec["m"], cohort_size=rec["cohort"],
                               sampler=rec["sampler"], seed=rec["seed"],
                               weights=weights,
                               availability=rec["availability"])
        assert [pop.cohort(t).tolist() for t in range(len(rec["ids"]))] \
            == rec["ids"], rec["setting"]


def test_population_bench_twin_flat_batches_growing_state(monkeypatch):
    from repro_torch.benchmarks import population_bench as pb
    monkeypatch.setattr(pb, "REPEATS", 1)
    small = pb.one_scale(32, "fedagrac", 4, 2, "cpu")
    big = pb.one_scale(1024, "fedagrac", 4, 2, "cpu")
    assert small["rounds_per_s"] > 0 and big["rounds_per_s"] > 0
    assert small["cohort_batch_bytes"] == big["cohort_batch_bytes"]
    # the ν⁽ⁱ⁾ store is the M-sized state: 32 × 640 against 1024 × 640
    assert (big["state_bytes"] - small["state_bytes"]
            == (1024 - 32) * 640 * 4)
