"""Buffered semi-asynchronous rounds in the port (fed/clock.py, the
population's dispatch hooks, ``BufferedAsyncSimulation``) against the JAX
package on the CPU.

* ``staleness_weight``, ``make_clock`` (all five speed models) and
  ``simulate_timeline`` over a speed-model × buffer grid and with each of
  the five samplers: equal to the reference's, array for array (both are
  numpy with the same ``default_rng`` streams).
* ``report_weights``, ``initial_dispatch`` and ``pick_dispatch``: the
  reference's picks from the same generator, bit for bit, a time-varying
  availability hook included.
* The per-client-anchor client update against the reference's
  ``make_flat_client_update(per_client_anchor=True)``.
* ``BufferedAsyncSimulation.run`` against the reference's on the flat
  layout: fedagrac, fedavg, fednova, scaffold and fedprox at buffer M, M/2
  and 1, the three staleness modes, on a lognormal clock whose buffers hold
  a client twice; partial participation (uniform, round_robin, weighted,
  ``cohort_nu_decay``).  Loss, K̄, mass and params within
  tests/test_torch_round.py's rtol 1e-5 / atol 2e-6, ν and ν⁽ⁱ⁾ within its
  atol 1e-5 (``recover_avg_grad`` divides by η·K_i); sim_time and
  staleness equal.
* Buffer = M at fixed speeds computes the port's synchronous round; a
  chunked run equals its per-update run bit for bit; a repeated id keeps
  its last occurrence's ν⁽ⁱ⁾ row, as the reference's scatter does.
* What the engine refuses (the tree layout, a mixed-precision master, a
  device sampler), naming the ROADMAP item; the example at 2 rounds.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import stages as jstages  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.data.pipeline import FederatedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import Dataset as JDataset  # noqa: E402
from repro.fed import async_engine as jasync  # noqa: E402
from repro.fed import clock as jclock  # noqa: E402
from repro.fed import population as jpop  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import flat, stages  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.data import Dataset, FederatedBatcher  # noqa: E402
from repro_torch.examples import buffered_async  # noqa: E402
from repro_torch.fed import (BufferedAsyncSimulation,  # noqa: E402
                             FederatedSimulation, async_engine, clock)
from repro_torch.fed import population as tpop  # noqa: E402
from repro_torch.models import simple  # noqa: E402

M, D, N_CLASSES, BATCH, T_UPDATES = 6, 8, 4, 5, 6
LR, LAM = 0.05, 0.5
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)
DISTS = ("fixed", "uniform", "lognormal", "bimodal", "trace")


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# the clock, the timeline and the dispatch hooks: equal to the reference's
# ---------------------------------------------------------------------------

def test_staleness_weight_bit_equal():
    tau = np.arange(0, 40).reshape(4, 10)
    for mode in ("constant", "hinge", "poly"):
        for a, b in ((0.5, 4), (1.0, 0), (0.3, 2)):
            np.testing.assert_array_equal(
                async_engine.staleness_weight(tau, mode, a, b),
                jasync.staleness_weight(tau, mode, a, b))
    with pytest.raises(ValueError, match="staleness mode"):
        async_engine.staleness_weight(tau, "exp")


def _clock_kw(dist, m=M):
    if dist == "trace":
        rng = np.random.default_rng(9)
        return dict(speeds=rng.uniform(0.2, 3.0, m),
                    latency=rng.uniform(0.0, 0.5, m))
    return dict(sigma=1.0, latency=0.25)


@pytest.mark.parametrize("dist", DISTS)
def test_make_clock_bit_equal(dist):
    got = clock.make_clock(M, dist=dist, seed=3, **_clock_kw(dist))
    want = jclock.make_clock(M, dist=dist, seed=3, **_clock_kw(dist))
    np.testing.assert_array_equal(got.speeds, want.speeds)
    np.testing.assert_array_equal(got.latency, want.latency)
    k = np.arange(1, M + 1)
    assert got.round_time(k) == want.round_time(k)
    assert got.duration(2, 7) == want.duration(2, 7)


def test_make_clock_refusals_match():
    for kw in (dict(dist="trace"), dict(dist="trace", speeds=np.ones(3)),
               dict(dist="trace", speeds=-np.ones(M)),
               dict(dist="lognormal", speeds=np.ones(M)),
               dict(dist="weibull"), dict(dist="fixed", latency=-1.0)):
        with pytest.raises(ValueError) as got:
            clock.make_clock(M, **kw)
        with pytest.raises(ValueError) as want:
            jclock.make_clock(M, **kw)
        assert str(got.value) == str(want.value)


def _assert_timelines_equal(got, want):
    for field in ("ids", "versions", "waves", "k_steps", "staleness",
                  "arrival_t", "fresh", "dispatch_ids", "k_sched",
                  "aborted"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _k_schedule(m=M, seed=4):
    return np.random.default_rng(seed).integers(1, 6, (7, m)).astype(
        np.int32)


@pytest.mark.parametrize("buffer", [M, M // 2, 1])
@pytest.mark.parametrize("dist", DISTS)
def test_simulate_timeline_bit_equal(dist, buffer):
    ks = _k_schedule()
    got = clock.simulate_timeline(
        ks, clock.make_clock(M, dist=dist, seed=3, **_clock_kw(dist)),
        buffer, 25)
    want = jclock.simulate_timeline(
        ks, jclock.make_clock(M, dist=dist, seed=3, **_clock_kw(dist)),
        buffer, 25)
    _assert_timelines_equal(got, want)


POP_M, POP_C = 40, 6


def _populations(sampler, m=POP_M, c=POP_C):
    rng = np.random.default_rng(11)
    kw = dict(cohort_size=c if sampler != "all" else m, sampler=sampler,
              seed=5, weights=rng.uniform(0.2, 3.0, m),
              availability=rng.uniform(0.0, 1.0, m))
    return tpop.ClientPopulation(m, **kw), jpop.ClientPopulation(m, **kw)


@pytest.mark.parametrize("sampler", sorted(tpop.SAMPLERS))
def test_simulate_timeline_with_population_bit_equal(sampler):
    tp, jp = _populations(sampler)
    ks = _k_schedule(POP_M)
    buffer = POP_C if sampler != "all" else POP_M // 2
    got = clock.simulate_timeline(
        ks, clock.make_clock(POP_M, dist="lognormal", sigma=1.0, seed=3),
        buffer, 30, population=tp)
    want = jclock.simulate_timeline(
        ks, jclock.make_clock(POP_M, dist="lognormal", sigma=1.0, seed=3),
        buffer, 30, population=jp)
    _assert_timelines_equal(got, want)
    if sampler != "all":
        # the concurrency cap: at most C distinct clients a buffer
        assert all(len(set(r)) <= POP_C for r in got.ids.tolist())


@pytest.mark.parametrize("sampler", sorted(tpop.SAMPLERS))
def test_dispatch_hooks_bit_equal(sampler):
    tp, jp = _populations(sampler)
    np.testing.assert_array_equal(tp.report_weights(), jp.report_weights())
    assert tp.report_weights().dtype == np.float32
    np.testing.assert_array_equal(tp.step_rate, jp.step_rate)
    g_rng, w_rng = (np.random.default_rng((5, 0x5eed)) for _ in range(2))
    first = tp.initial_dispatch(g_rng)
    np.testing.assert_array_equal(first, jp.initial_dispatch(w_rng))
    busy = np.zeros(POP_M, bool)
    busy[first] = True
    for step in range(60):
        freed = int(first[step % len(first)])
        busy[freed] = False
        got = tp.pick_dispatch(g_rng, busy, freed, phase=step)
        assert got == jp.pick_dispatch(w_rng, busy, freed, phase=step)
        busy[got] = True
        first[step % len(first)] = got
    # the generators were drawn from alike: the streams are still in step
    assert g_rng.random() == w_rng.random()


def test_pick_dispatch_scan_fallback_bit_equal():
    """With almost every client busy the 64 rejections run out and the
    O(M) scan picks, as in the reference."""
    tp, jp = _populations("weighted", m=70, c=69)
    g_rng, w_rng = (np.random.default_rng(1) for _ in range(2))
    busy = np.ones(70, bool)
    busy[[3, 50]] = False
    for _ in range(5):
        assert tp.pick_dispatch(g_rng, busy, 3) == \
            jp.pick_dispatch(w_rng, busy, 3)


def test_availability_hook_is_refused():
    """The time-varying availability hook the port refused before failure
    scenarios came (ROADMAP A8) now drives the dispatch profile: the
    initial dispatch and the picks at several phases equal the
    reference's under the same hook."""
    tp, jp = _populations("availability")
    hook = (lambda t: np.where(np.arange(POP_M) % 3 == t % 3, 0.05, 1.0)
            .astype(np.float32))
    tp.availability_fn = hook
    jp.availability_fn = lambda t: jnp.where(
        jnp.arange(POP_M) % 3 == t % 3, 0.05, 1.0).astype(jnp.float32)
    g_rng, w_rng = (np.random.default_rng(5) for _ in range(2))
    assert np.array_equal(tp.initial_dispatch(g_rng),
                          jp.initial_dispatch(w_rng))
    busy = np.zeros(POP_M, bool)
    for phase in range(6):
        assert tp.pick_dispatch(g_rng, busy, 0, phase=phase) == \
            jp.pick_dispatch(w_rng, busy, 0, phase=phase)


# ---------------------------------------------------------------------------
# the per-client-anchor client update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["fedagrac", "fedprox", "fedavg"])
def test_per_client_anchor_update_matches_jax(algorithm):
    rng = np.random.default_rng(2)
    params = {"w": (0.5 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": np.zeros(N_CLASSES, np.float32)}
    k_max, b = 4, 3
    jspec = jflat.make_flat_spec(jax.tree.map(jnp.asarray, params))
    spec = flat.make_flat_spec({k: torch.from_numpy(v)
                                for k, v in params.items()})
    anchors = (0.5 * rng.standard_normal((b, spec.p))).astype(np.float32)
    anchors[:, spec.n:] = 0
    c = (0.1 * rng.standard_normal((b, spec.p))).astype(np.float32)
    c[:, spec.n:] = 0
    k = np.array([1, 4, 2], np.int32)
    batches = {"x": rng.standard_normal((b, k_max, 5, D)).astype(np.float32),
               "y": rng.integers(0, N_CLASSES, (b, k_max, 5)).astype(
                   np.int32)}
    kw = dict(algorithm=algorithm, n_clients=b, lr=LR, calibration_rate=LAM)
    jfn = jflat.make_flat_client_update(
        jspec, jsimple.lr_loss, j_get_algorithm(algorithm, JFedConfig(**kw)),
        lr=LR, k_max=k_max, per_client_anchor=True)
    tfn = flat.make_flat_client_update(
        spec, simple.lr_loss, get_algorithm(algorithm, FedConfig(**kw)),
        lr=LR, k_max=k_max, per_client_anchor=True)
    jx, jg0, _, jloss = jfn(jnp.asarray(anchors), jnp.asarray(c),
                            jax.tree.map(jnp.asarray, batches),
                            jnp.asarray(k), jnp.float32(LAM))
    t_anchors = torch.from_numpy(anchors)
    tx, tg0, _, tloss = tfn(t_anchors, torch.from_numpy(c),
                         {kk: torch.from_numpy(v) for kk, v in
                          batches.items()}, torch.from_numpy(k), LAM)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **PARAMS_TOL)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                               **PARAMS_TOL)
    if tg0 is not None:
        np.testing.assert_allclose(tg0.numpy(), np.asarray(jg0),
                                   **PARAMS_TOL)
    # the anchor rows are read, never written
    np.testing.assert_array_equal(t_anchors.numpy(), anchors)


# ---------------------------------------------------------------------------
# BufferedAsyncSimulation against the reference's
# ---------------------------------------------------------------------------

def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((120, D)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, 120).astype(np.int32)
    sizes = (20, 16, 12, 20, 16, 12)
    starts = np.cumsum((0,) + sizes[:-1])
    parts = [np.arange(s, s + n) for s, n in zip(starts, sizes)]
    params = {"w": (0.3 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": np.zeros(N_CLASSES, np.float32)}
    ks = rng.integers(1, 5, (50, M)).astype(np.int32)
    return x, y, parts, params, ks


def _engines(kw, clock_kw=None, population=None, m=M, task=None):
    """The reference's engine and the port's on the same task, config and
    clock."""
    x, y, parts, params, ks = task or _task()
    kw = dict(dict(n_clients=m, lr=LR, calibration_rate=LAM,
                   weights="data", staleness_a=0.5, staleness_b=1,
                   param_layout="flat"), **kw)
    clock_kw = clock_kw or dict(dist="lognormal", sigma=1.0, seed=3)
    jsim = jasync.BufferedAsyncSimulation(
        jsimple.lr_loss, jax.tree.map(jnp.asarray, params),
        JFedConfig(**kw),
        JBatcher(JDataset(jnp.asarray(x), jnp.asarray(y)), parts,
                 batch_size=BATCH),
        k_schedule=ks, clock=jclock.make_clock(m, **clock_kw))
    tsim = BufferedAsyncSimulation(
        simple.lr_loss, {k: torch.from_numpy(v) for k, v in params.items()},
        FedConfig(**kw),
        FederatedBatcher(Dataset(torch.from_numpy(x),
                                 torch.from_numpy(y).long()), parts,
                         batch_size=BATCH, device="cpu"),
        k_schedule=ks, clock=clock.make_clock(m, **clock_kw),
        device="cpu")
    return jsim, tsim


def _assert_runs_close(jsim, jh, tsim, th):
    for key in ("loss", "kbar", "mass"):
        np.testing.assert_allclose(getattr(th, key), getattr(jh, key),
                                   **PARAMS_TOL, err_msg=key)
    for key in ("sim_time", "staleness", "bytes_up", "bytes_down"):
        assert getattr(th, key) == getattr(jh, key), key
    np.testing.assert_allclose(tsim.state["params"].numpy(),
                               np.asarray(jsim.state["params"]),
                               **PARAMS_TOL)
    for key in ("nu", "nu_i"):
        if key in jsim.state:
            np.testing.assert_allclose(tsim.state[key].numpy(),
                                       np.asarray(jsim.state[key]),
                                       **NU_TOL, err_msg=key)
    assert int(tsim.state["round"]) == int(jsim.state["round"])


def _has_repeats(sim, t_updates):
    tl = clock.simulate_timeline(sim.k_schedule, sim.clock, sim.buffer,
                                 t_updates, population=sim.population)
    return any(len(set(r)) < len(r) for r in tl.ids.tolist())


@pytest.mark.parametrize("buffer", [M, M // 2, 1])
@pytest.mark.parametrize("algorithm", ["fedagrac", "fedavg", "fednova",
                                       "scaffold", "fedprox"])
def test_async_run_matches_jax(algorithm, buffer):
    jsim, tsim = _engines(dict(algorithm=algorithm, buffer_size=buffer,
                               staleness="hinge"))
    jh, th = jsim.run(T_UPDATES), tsim.run(T_UPDATES)
    _assert_runs_close(jsim, jh, tsim, th)
    if buffer == M // 2:
        # the clock puts a fast client twice into one buffer
        assert _has_repeats(tsim, T_UPDATES)


@pytest.mark.parametrize("staleness", ["constant", "poly"])
def test_async_staleness_modes_match_jax(staleness):
    jsim, tsim = _engines(dict(algorithm="fedagrac", buffer_size=M // 2,
                               staleness=staleness))
    jh, th = jsim.run(T_UPDATES), tsim.run(T_UPDATES)
    _assert_runs_close(jsim, jh, tsim, th)
    assert max(th.staleness) > 0


@pytest.mark.parametrize("sampler,decay", [
    ("uniform", 0.0), ("round_robin", 0.0), ("weighted", 0.0),
    ("uniform", 0.3)])
def test_population_async_matches_jax(sampler, decay):
    m = 12
    rng = np.random.default_rng(7)
    x = rng.standard_normal((240, D)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, 240).astype(np.int32)
    parts = [np.arange(20 * i, 20 * i + 20 - (i % 3) * 5) for i in range(m)]
    params = {"w": (0.3 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32), "b": np.zeros(N_CLASSES,
                                                        np.float32)}
    ks = rng.integers(1, 5, (50, m)).astype(np.int32)
    jsim, tsim = _engines(
        dict(algorithm="fedagrac", cohort_size=4, cohort_sampler=sampler,
             cohort_nu_decay=decay, staleness="hinge"), m=m,
        task=(x, y, parts, params, ks))
    assert tsim.buffer == 4 and not tsim.population.full_participation
    jh, th = jsim.run(T_UPDATES), tsim.run(T_UPDATES)
    _assert_runs_close(jsim, jh, tsim, th)


def test_buffer_m_fixed_speeds_is_the_synchronous_round():
    """Equal K and equal speeds: every report ties, each buffer is one
    synchronous round."""
    x, y, parts, params, _ = _task()
    ks = np.full((9, M), 3, np.int32)
    fed = FedConfig(algorithm="fedagrac", n_clients=M, lr=LR,
                    calibration_rate=LAM, weights="data",
                    param_layout="flat")
    batcher = FederatedBatcher(Dataset(torch.from_numpy(x),
                                       torch.from_numpy(y).long()), parts,
                               batch_size=BATCH, device="cpu")
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    sync = FederatedSimulation(simple.lr_loss, tparams, fed, batcher,
                               k_schedule=ks, device="cpu")
    hs = sync.run(4)
    full = BufferedAsyncSimulation(
        simple.lr_loss, tparams,
        dataclasses.replace(fed, buffer_size=M, speed_dist="fixed"),
        batcher, k_schedule=ks, device="cpu")
    hf = full.run(4)
    np.testing.assert_allclose(hf.loss, hs.loss, **PARAMS_TOL)
    np.testing.assert_allclose(hf.kbar, hs.kbar, **PARAMS_TOL)
    np.testing.assert_allclose(hf.mass, 1.0, rtol=1e-6)
    assert hf.staleness == [0.0] * 4
    np.testing.assert_allclose(full.state["params"].numpy(),
                               sync.state["params"].numpy(), **PARAMS_TOL)
    np.testing.assert_allclose(full.state["nu_i"].numpy(),
                               sync.state["nu_i"].numpy(), **NU_TOL)


@pytest.mark.parametrize("algorithm", ["fedagrac", "fedavg"])
def test_chunked_run_equals_per_update_run(algorithm):
    kw = dict(algorithm=algorithm, buffer_size=M // 2, staleness="hinge")
    _, per_update = _engines(kw)
    _, chunked = _engines(kw)
    h1 = per_update.run(8, chunk_updates=1)
    h2 = chunked.run(8, chunk_updates=3)
    assert h1.loss == h2.loss and h1.kbar == h2.kbar and h1.mass == h2.mass
    for key, v in per_update.state.items():
        assert torch.equal(v, chunked.state[key]), key
    assert torch.equal(per_update._anchors, chunked._anchors)


def test_eval_cadence_clamps_chunks():
    x, y, parts, params, ks = _task()
    _, tsim = _engines(dict(algorithm="fedavg", buffer_size=2))
    tsim.eval_fn = lambda p: float(p["b"].abs().sum())
    with pytest.warns(UserWarning, match="clamped"):
        hist = tsim.run(6, eval_every=2, chunk_updates=4)
    assert len(hist.metric) == 3 and len(hist.loss) == 6


def test_repeated_reporter_keeps_its_last_row():
    """A client twice in one buffer: the reference's CPU scatter keeps the
    LAST occurrence's row; the port's, with ``last``, the same one."""
    ids = np.array([1, 3, 1, 1, 3, 0])
    rows = np.arange(6 * 4, dtype=np.float32).reshape(6, 4)
    want = np.asarray(jstages.scatter_nu_rows(
        jnp.zeros((5, 4)), jnp.zeros(4), jnp.asarray(rows),
        jnp.asarray(ids)))
    np.testing.assert_array_equal(want[1], rows[3])     # last occurrence
    np.testing.assert_array_equal(want[3], rows[4])
    last = stages.last_occurrence(ids)
    np.testing.assert_array_equal(last, [3, 4, 3, 3, 4, 5])
    for in_place in (False, True):
        got = stages.scatter_nu_rows(
            torch.zeros(5, 4), torch.zeros(4), torch.from_numpy(rows),
            torch.from_numpy(ids), in_place=in_place,
            last=torch.from_numpy(last))
        np.testing.assert_array_equal(got.numpy(), want)
    # the rows written carry one value per id, whatever the write order
    for i in set(ids.tolist()):
        assert len(set(last[ids == i].tolist())) == 1


def test_write_ids_route_earlier_dispatches_to_the_scratch_row():
    dispatch = np.array([[2, 0, 2, 1], [1, 1, 1, 3]])
    np.testing.assert_array_equal(async_engine.write_ids(dispatch, 4),
                                  [[4, 0, 2, 1], [4, 4, 1, 3]])


def test_history_records_and_rerun_restarts_the_timeline():
    _, tsim = _engines(dict(algorithm="fedagrac", buffer_size=3,
                            staleness="hinge"))
    h1 = tsim.run(4)
    assert len(h1.sim_time) == len(h1.staleness) == len(h1.wall) == 4
    assert h1.sim_time == sorted(h1.sim_time)
    assert h1.bytes_up == [3 * tsim._wire["uplink_per_client"]] * 4
    assert tsim._anchors.shape == (M + 1, tsim._spec.p)
    h2 = tsim.run(2)
    assert tsim.version == 6 and h2.staleness[0] == 0.0
    assert h2.sim_time == h1.sim_time[:2]


# ---------------------------------------------------------------------------
# what the engine refuses, and the synchronous engine's buffer_size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    (dict(param_layout="tree"), "A2"), (dict(master_dtype="float32"), "A3"),
    ("sampler", "A5")])
def test_async_refusals_name_the_roadmap_item(kw, item):
    """The items these cases once refused now run: the tree layout (A2)
    matches the reference's tree engine; the device sampler (A5) and a
    mixed-precision master (A3: bfloat16 leaves over a float32 buffer)
    run (their parity: tests/test_torch_device_mode.py and
    tests/test_torch_master_dtype.py)."""
    if item == "A2":
        jsim, tsim = _engines(dict(algorithm="fedagrac", buffer_size=2,
                                   staleness="hinge", **kw))
        jh, th = jsim.run(T_UPDATES), tsim.run(T_UPDATES)
        np.testing.assert_allclose(th.loss, jh.loss, **PARAMS_TOL)
        assert th.sim_time == jh.sim_time
        for key, tol in (("params", PARAMS_TOL), ("nu", NU_TOL),
                         ("nu_i", NU_TOL)):
            assert set(tsim.state[key]) == {"w", "b"}
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    tsim.state[key][leaf].numpy(),
                    np.asarray(jsim.state[key][leaf]), **tol,
                    err_msg=f"{key}/{leaf}")
        return
    x, y, parts, params, ks = _task()
    data = Dataset(torch.from_numpy(x), torch.from_numpy(y).long())
    batcher = FederatedBatcher(data, parts, batch_size=BATCH, device="cpu")
    if item == "A3":
        fed = FedConfig(algorithm="fedavg", n_clients=M, buffer_size=2,
                        param_layout="flat", **kw)
        def bf16_loss(p, b):
            # torch does not promote float32 features against bfloat16
            # weights, as jnp does: the features are cast to the leaves'
            return simple.lr_loss(p, dict(b, x=b["x"].bfloat16()))
        sim = BufferedAsyncSimulation(
            bf16_loss,
            {k: torch.from_numpy(v).bfloat16() for k, v in params.items()},
            fed, batcher, k_schedule=ks, device="cpu")
        assert sim._spec.dtype == torch.float32
        assert set(sim._spec.dtypes) == {torch.bfloat16}
        assert np.isfinite(sim.run(2).loss).all()
        assert sim.state["params"].dtype == torch.float32
        assert {t.dtype for t in sim.params.values()} == {torch.bfloat16}
        return
    from repro_torch.data import DeviceBatcher
    fed = FedConfig(algorithm="fedavg", n_clients=M, buffer_size=2,
                    param_layout="flat")
    sim = BufferedAsyncSimulation(
        simple.lr_loss, {k: torch.from_numpy(v) for k, v in params.items()},
        fed, DeviceBatcher(data, parts, batch_size=BATCH, device="cpu"),
        k_schedule=ks, device="cpu")
    assert sim._device_sampler
    assert np.isfinite(sim.run(2).loss).all()


def test_buffer_size_out_of_range_raises():
    for kw in (dict(buffer_size=M + 1),
               dict(buffer_size=5, cohort_size=3)):
        with pytest.raises(ValueError, match="buffer_size"):
            _engines(dict(algorithm="fedavg", **kw))


def test_example_runs_on_cpu(capsys):
    out = buffered_async.main(["--rounds", "2", "--device", "cpu"])
    assert out["drift"] < 1e-5
    assert len(out["buffered"].loss) == 6
    assert "buffer=M vs synchronous" in capsys.readouterr().out
