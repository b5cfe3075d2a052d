"""Wire compression on the cohort round and on the buffered-async round in
the port, against the JAX package on the CPU.

* ``make_flat_cohort_round(compression=…)`` against the reference's, fed
  the same cohorts, batches, K and weights, for each uplink codec (error
  feedback on and off), an int8 broadcast, and a ``weighted`` cohort that
  draws a client twice: params, ν, ν⁽ⁱ⁾ and the error-feedback stores over
  3 rounds.  With ``donate=True`` the stores are updated in place (the same
  storage after the round) and hold what the copying round computes.
* ``BufferedAsyncSimulation`` with compression against the reference's:
  fedagrac and fedavg, uplink and broadcast codecs, on a clock whose
  buffers hold a client twice (its error-feedback row keeps the last
  occurrence's residual, as the reference's scatter does); the wire bytes
  per update equal; ``compressor="none"`` leaves the run bit-identical to
  a config without compression.
* The rows stage with a repeated id against the reference's, in place and
  not; ``init_state``'s broadcast carry and ``convert`` carrying a JAX
  async state's ``bc_*`` keys across; the synchronous simulation running a
  compressed cohort config; the compression twin's bytes columns equal to
  the reference's quick rows.

Tolerances are tests/test_torch_round.py's: params rtol 1e-5 / atol 2e-6,
ν, ν⁽ⁱ⁾ and the residuals atol 1e-5.  A codec's output moves by a whole
quantization step where its input sits within rounding of a rounding
boundary; the inputs here are seeded and none does.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.fed import population as jpop  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import compression_bench  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import compress, flat, rounds, stages  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.data import FederatedBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from test_torch_async import M, _engines, _has_repeats  # noqa: E402

PM, C, B, D, N_CLASSES, K_MAX = 10, 4, 5, 8, 4, 3
LR, LAM = 0.05, 0.5
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)
STORES = ("nu", "nu_i", "ef_up", "ef_nu", "ef_down", "ef_down_nu")
REFERENCE = json.loads((Path(compression_bench.__file__).with_name(
    "reference_quick.json")).read_text())


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# the compressed cohort round
# ---------------------------------------------------------------------------

def _cohort_inputs(sampler, n_rounds=3, seed=5):
    rng = np.random.default_rng(seed)
    params = {"w": (0.5 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": (0.5 * rng.standard_normal(N_CLASSES)).astype(np.float32)}
    k_row = rng.integers(1, K_MAX + 1, PM).astype(np.int32)
    pop = jpop.ClientPopulation(PM, cohort_size=C, sampler=sampler, seed=2,
                                weights=rng.random(PM) + 0.5)
    rounds_in = []
    for t in range(n_rounds):
        ids, cw = (np.array(a) for a in pop.host_cohort(t))
        if sampler == "weighted" and t == 1:
            ids = np.array([1, 5, 1, 3], np.int32)   # a repeated id
        rounds_in.append((
            ids, cw, k_row[ids],
            {"x": rng.standard_normal((C, K_MAX, B, D)).astype(np.float32),
             "y": rng.integers(0, N_CLASSES, (C, K_MAX, B)).astype(
                 np.int32)}))
    return params, rounds_in


def _cohort_kw(algorithm, up, down, ef):
    return dict(algorithm=algorithm, n_clients=PM, lr=LR,
                calibration_rate=LAM, param_layout="flat", cohort_size=C,
                compressor=up, broadcast_compressor=down,
                error_feedback=ef, topk_frac=0.2)


def _run_jax_cohort(kw, params, rounds_in):
    jfed = JFedConfig(**kw)
    algo = j_get_algorithm(kw["algorithm"], jfed)
    jp = jax.tree.map(jnp.asarray, params)
    spec = jflat.make_flat_spec(jp)
    comp = jcompress.CompressionConfig.from_fed(jfed)
    fn = jax.jit(jflat.make_flat_cohort_round(
        spec, jsimple.lr_loss, algo, lr=LR, k_max=K_MAX, compression=comp))
    state = jrounds.init_state(jflat.ravel(spec, jp), PM, algo,
                               compression=comp, spec=spec)
    for ids, cw, k, b in rounds_in:
        state, metrics = fn(state, jax.tree.map(jnp.asarray, b),
                            jnp.asarray(ids), jnp.asarray(k),
                            jnp.asarray(cw), jnp.float32(LAM))
    return jax.tree.map(np.asarray, state), jax.tree.map(np.asarray,
                                                         metrics)


def _run_port_cohort(kw, params, rounds_in, donate):
    fed = FedConfig(**kw)
    algo = get_algorithm(kw["algorithm"], fed)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    comp = compress.CompressionConfig.from_fed(fed)
    fn = flat.make_flat_cohort_round(spec, simple.lr_loss, algo, lr=LR,
                                     k_max=K_MAX, compression=comp)
    state = rounds.init_state(flat.ravel(spec, tp), PM, algo,
                              compression=comp, spec=spec)
    before = {k: state[k].data_ptr() for k in STORES
              if k in state and state[k].dim() == 2}
    for ids, cw, k, b in rounds_in:
        last = stages.last_occurrence(ids)
        state, metrics = fn(state, {kk: torch.from_numpy(v)
                                    for kk, v in b.items()},
                            torch.from_numpy(ids).long(),
                            torch.from_numpy(k), torch.from_numpy(cw), LAM,
                            donate=donate, last=torch.from_numpy(last))
    return state, metrics, before


def _assert_states_close(got, want):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["params"].numpy(), want["params"],
                               **PARAMS_TOL)
    for key in STORES:
        if key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       **NU_TOL, err_msg=key)


@pytest.mark.parametrize("algorithm,up,down,ef,sampler", [
    ("fedagrac", "int8", "none", True, "uniform"),
    ("fedagrac", "int4", "none", True, "uniform"),
    ("fedagrac", "topk", "none", True, "uniform"),
    ("fedagrac", "topk+int8", "none", True, "uniform"),
    ("fedagrac", "int8", "int8", True, "uniform"),
    ("fedagrac", "topk", "int4", False, "uniform"),
    ("fedavg", "topk+int8", "int8", True, "uniform"),
    ("fedagrac", "int8", "int8", True, "weighted")])
def test_compressed_cohort_round_matches_jax(algorithm, up, down, ef,
                                             sampler):
    kw = _cohort_kw(algorithm, up, down, ef)
    params, rounds_in = _cohort_inputs(sampler)
    want_state, want_metrics = _run_jax_cohort(kw, params, rounds_in)
    for donate in (False, True):
        state, metrics, before = _run_port_cohort(kw, params, rounds_in,
                                                  donate)
        _assert_states_close(state, want_state)
        for key in ("loss", "kbar", "mass"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(want_metrics[key]),
                                       **PARAMS_TOL, err_msg=key)
        if donate:
            # the (M, P) stores stayed where they were: no round copied one
            assert {k: state[k].data_ptr() for k in before} == before


def test_simulation_runs_a_compressed_cohort_config():
    data, parts = fedprox_synthetic(0, 6, d=8, n_classes=4, n_per_client=20)
    fed = FedConfig(algorithm="fedagrac", n_clients=6, cohort_size=2,
                    compressor="int8", broadcast_compressor="int8",
                    param_layout="flat", lr=LR)
    sim = FederatedSimulation(
        simple.lr_loss, {"w": torch.zeros(8, 4), "b": torch.zeros(4)}, fed,
        FederatedBatcher(data, parts, batch_size=4, device="cpu"),
        k_schedule=np.full((1, 6), 2, np.int32), device="cpu")
    assert sim._partial and sim.compression is not None
    h1 = sim.run(3, chunk_rounds=1)
    assert sim.state["ef_up"].shape == (6, sim._spec.p)
    assert h1.bytes_up == [2 * sim._wire["uplink_per_client"]] * 3
    assert np.isfinite(h1.loss).all()
    # rows written only for the clients drawn
    drawn = {int(i) for t in range(3) for i in sim.population.cohort(t)}
    written = set(torch.nonzero(sim.state["ef_up"].abs().sum(1))
                  .flatten().tolist())
    assert written <= drawn and written


# ---------------------------------------------------------------------------
# the compressed buffered-async round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm,up,down", [
    ("fedagrac", "int8", "none"), ("fedagrac", "topk", "none"),
    ("fedagrac", "int8", "int8"), ("fedagrac", "topk+int8", "int4"),
    ("fedavg", "int4", "int8"), ("fedavg", "topk", "none")])
def test_compressed_async_run_matches_jax(algorithm, up, down):
    jsim, tsim = _engines(dict(algorithm=algorithm, buffer_size=M // 2,
                               staleness="hinge", compressor=up,
                               broadcast_compressor=down, topk_frac=0.2))
    assert _has_repeats(tsim, 6)
    jh, th = jsim.run(6), tsim.run(6)
    for key in ("loss", "kbar", "mass"):
        np.testing.assert_allclose(getattr(th, key), getattr(jh, key),
                                   **PARAMS_TOL, err_msg=key)
    assert th.bytes_up == jh.bytes_up and th.bytes_down == jh.bytes_down
    want = jax.tree.map(np.asarray, jsim.state)
    _assert_states_close({k: v for k, v in tsim.state.items()}, want)
    for key in compress.BC_KEYS:
        if key in want:
            np.testing.assert_allclose(tsim.state[key].numpy(), want[key],
                                       **NU_TOL, err_msg=key)


def test_async_compressor_none_is_bit_identical():
    runs = []
    for kw in ({}, {"compressor": "none", "broadcast_compressor": "none"}):
        _, tsim = _engines(dict(algorithm="fedagrac", buffer_size=3,
                                staleness="hinge", **kw))
        hist = tsim.run(5)
        runs.append((tsim.state, hist))
    (s0, h0), (s1, h1) = runs
    assert sorted(s0) == sorted(s1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert h0.loss == h1.loss and h0.bytes_up == h1.bytes_up


def test_rows_stage_with_a_repeated_id_matches_jax():
    """Two reports of client 1 in one buffer: each compresses with the
    accumulator it read, the residual kept is the last one's."""
    rng = np.random.default_rng(3)
    n, p = 200, 256
    ef = (0.01 * rng.standard_normal((5, p))).astype(np.float32)
    rows = rng.standard_normal((4, p)).astype(np.float32)
    ids = np.array([1, 4, 1, 0])
    jcodec = jcompress.make_codec("int8", n)
    jstage = jcompress.make_rows_stage(jcodec, True, "ef_up")
    jnew = {}
    jout = jstage(jnp.asarray(rows), {"ef_up": jnp.asarray(ef)}, jnew,
                  ids=jnp.asarray(ids))
    tstage = compress.make_rows_stage(compress.make_codec("int8", n), True,
                                      "ef_up")
    last = torch.from_numpy(stages.last_occurrence(ids))
    for in_place in (False, True):
        state = {"ef_up": torch.from_numpy(ef.copy())}
        new = {}
        out = tstage(torch.from_numpy(rows), state, new,
                     ids=torch.from_numpy(ids), last=last,
                     in_place=in_place)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(new["ef_up"].numpy(),
                                   np.asarray(jnew["ef_up"]), rtol=1e-6,
                                   atol=1e-7)
        assert (new["ef_up"] is state["ef_up"]) == in_place
        if not in_place:
            # the caller's store is left alone
            np.testing.assert_array_equal(state["ef_up"].numpy(), ef)


def test_broadcast_carry_in_state_and_across_conversion():
    fed = FedConfig(algorithm="fedagrac", n_clients=M, buffer_size=3,
                    compressor="int8", broadcast_compressor="int8",
                    param_layout="flat")
    algo = get_algorithm("fedagrac", fed)
    comp = compress.CompressionConfig.from_fed(fed)
    spec = flat.make_flat_spec({"w": torch.zeros(8, 4)})
    state = rounds.init_state(torch.zeros(spec.p), M, algo,
                              compression=comp, spec=spec,
                              broadcast_carry=True)
    assert set(compress.BC_KEYS) <= set(state)
    plain = rounds.init_state(torch.zeros(spec.p), M, algo,
                              compression=comp, spec=spec)
    assert not set(compress.BC_KEYS) & set(plain)
    assert compress.FLAT_STATE_KEYS == jcompress.FLAT_STATE_KEYS
    # a JAX async state after a run carries its broadcast across
    jsim, tsim = _engines(dict(algorithm="fedagrac", buffer_size=3,
                               staleness="hinge", compressor="int8",
                               broadcast_compressor="int8"))
    jsim.run(3)
    carried = convert.flat_state_from_numpy(
        jax.tree.map(np.asarray, jsim.state), "cpu")
    assert set(carried) == set(jsim.state)
    for key in compress.BC_KEYS:
        np.testing.assert_array_equal(carried[key].numpy(),
                                      np.asarray(jsim.state[key]))


def test_compression_twin_bytes_are_the_reference_quick_rows(monkeypatch,
                                                             capsys):
    """Every row's wire bytes and reduction (which do not depend on the
    rounds) equal the reference's quick rows; at 2 rounds the rest are the
    run's own."""
    monkeypatch.setattr(compression_bench, "T_QUICK", 2)
    monkeypatch.setattr(compression_bench, "GOLDEN_ROUNDS_QUICK", 2)
    compression_bench.main(quick=True, device="cpu")
    lines = [ln.split(",") for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("#")]
    ref = REFERENCE["modules"]["compression"]
    assert lines[0] == ref["header"]
    assert [r[:3] + r[4:6] for r in lines[1:]] == \
        [r[:3] + r[4:6] for r in ref["rows"]]
