"""The port's training half of the launch layer (``repro_torch.launch.train``)
against the reference's single-device rounds.

One ``gloo`` group of 4 ranks on a ``(2, 2)`` ``("data", "model")`` CPU mesh
(``tests/_torch_train_mesh_worker.py``, spawned once for the file under a
hard limit of GROUP_LIMIT_S) trains reduced llama3-8b (2 layers, d 128,
vocab 256) from the reference's weights at M = 2 clients (one a data
slice) through ``build_train_round`` (tree and flat layouts, fedagrac and
fedavg) and ``build_population_round`` (a cohort of 2 over 4 clients'
ν⁽ⁱ⁾ store), with K_i of 1 and 2.  Each result, made whole, is held to the
reference's ``rounds.make_round`` / ``flat.make_flat_round`` /
``stages.make_cohort_round`` on one device, on the same inputs, within the
reference's own sharded-round tolerance (``tests/test_dist_spmd.py``): rtol
2e-4 and atol 2e-5 on params, ν and ν⁽ⁱ⁾, the loss within 1e-3.  The
reference's own sharded round fails on this jax.  A chunk of 2 rounds and
its tail of 1 equal three rounds bit for bit, every leaf a spec shards is
sharded on every rank, and a MoE arch is refused.  ``main`` runs on a
one-rank CPU mesh in the test process.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig, reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.core import flat as jflat, rounds as jrounds  # noqa: E402
from repro.core import stages as jstages  # noqa: E402
from repro.core.fedopt import get_algorithm as jget_algorithm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.checkpoint import serialize  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_train_mesh_worker.py")
WORLD = 4
GROUP_LIMIT_S = 150
RTOL, ATOL, LOSS_TOL = 2e-4, 2e-5, 1e-3     # tests/test_dist_spmd.py:74-82
M, K_MAX, B_LOCAL, SEQ, LR = 2, 2, 2, 16, 0.1
M_POPULATION = 4
K_STEPS = ((1, 2), (2, 1), (1, 2))
WEIGHTS = (0.4, 0.6)
COHORTS = ((3, 1), (0, 3))
CWEIGHTS = ((0.5, 0.5), (0.6, 0.4))
# (key, layout, algorithm, rounds): _torch_train_mesh_worker.RUNS
RUNS = (("tree/fedagrac", "tree", "fedagrac", 2),
        ("tree/fedavg", "tree", "fedavg", 1),
        ("flat/fedagrac", "flat", "fedagrac", 2),
        ("flat/fedavg", "flat", "fedavg", 1))


def _cfg():
    return dataclasses.replace(reduced(get_arch("llama3-8b"), n_layers=2,
                                       d_model=128), vocab=256)


def _inputs(root: Path) -> dict:
    """The reference's weights (written under ``root`` in the port's
    checkpoint format) and three rounds' seeded batches (``inputs.npz``)."""
    jdist.unset_mesh()
    cfg = _cfg()
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    serialize.save(str(root / "weights.msgpack"), lm_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    rng = np.random.default_rng(0)
    seqs = rng.integers(1, cfg.vocab, (3, M, K_MAX, B_LOCAL, SEQ + 1)
                        ).astype(np.int32)
    inputs = {"tokens": seqs[..., :-1], "labels": seqs[..., 1:],
              "k_steps": np.array(K_STEPS, np.int32),
              "weights": np.array(WEIGHTS, np.float32),
              "cohorts": np.array(COHORTS, np.int64),
              "cweights": np.array(CWEIGHTS, np.float32),
              "m_population": np.int64(M_POPULATION), "lr": np.float64(LR)}
    np.savez(root / "inputs.npz", **inputs)
    return {"params": params, **inputs}


def _expected(inp: dict) -> dict:
    """The reference's single-device rounds on the same inputs."""
    jdist.unset_mesh()
    cfg, params = _cfg(), inp["params"]
    spec = jflat.make_flat_spec(params)

    def loss(p, b):
        return JM.lm_loss(p, b, cfg)

    def batch(t):
        return {k: jnp.asarray(inp[k][t]) for k in ("tokens", "labels")}

    def rows(t, client_dims=0):
        return np.asarray(jflat.ravel(spec, t, client_dims)
                          if isinstance(t, dict) else t)

    def record(ref, key, state, losses):
        ref[f"{key}/params"] = rows(state["params"])
        if "nu" in state:
            ref[f"{key}/nu"] = rows(state["nu"])
            ref[f"{key}/nu_i"] = rows(state["nu_i"], 1)
        ref[f"{key}/loss"] = np.array(losses)

    ref = {}
    w = jnp.asarray(inp["weights"])
    for key, layout, algo_name, n_rounds in RUNS:
        algo = jget_algorithm(algo_name, JFedConfig(algorithm=algo_name,
                                                    lr=LR))
        if layout == "flat":
            fn = jflat.make_flat_round(spec, loss, algo, lr=LR, k_max=K_MAX)
            state = jrounds.init_state(jflat.ravel(spec, params), M, algo)
        else:
            fn = jrounds.make_round(loss, algo, lr=LR, k_max=K_MAX)
            state = jrounds.init_state(params, M, algo)
        fn, losses = jax.jit(fn), []
        for t in range(n_rounds):
            state, met = fn(state, batch(t), jnp.asarray(inp["k_steps"][t]), w)
            losses.append(float(met["loss"]))
        record(ref, key, state, losses)
    algo = jget_algorithm("fedagrac", JFedConfig(algorithm="fedagrac", lr=LR))
    fn = jax.jit(jstages.make_cohort_round(loss, algo, lr=LR, k_max=K_MAX))
    state, losses = jrounds.init_state(params, M_POPULATION, algo), []
    for t in range(2):
        state, met = fn(state, batch(t),
                        jnp.asarray(inp["cohorts"][t], jnp.int32),
                        jnp.asarray(inp["k_steps"][t]),
                        jnp.asarray(inp["cweights"][t]))
        losses.append(float(met["loss"]))
    record(ref, "population", state, losses)
    return ref


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank group's results beside the reference's, computed while
    the ranks run; past GROUP_LIMIT_S every rank is killed and the fixture
    fails."""
    root = tmp_path_factory.mktemp("train_mesh")
    inp = _inputs(root)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(root)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + GROUP_LIMIT_S
    try:
        ref = _expected(inp)
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    tails = {r: (root / f"rank{r}.log").read_text()[-3000:]
             for r in range(WORLD)}
    if hung:
        pytest.fail(f"the gloo group did not finish in {GROUP_LIMIT_S} s; "
                    f"logs: {tails}")
    bad = {r: tails[r] for r, p in enumerate(procs) if p.returncode}
    assert not bad, f"ranks failed: {bad}"
    checks = [json.loads((root / f"checks_{r}.json").read_text())
              for r in range(WORLD)]
    with np.load(root / "out.npz") as out:
        return {"ref": ref, "out": dict(out), "checks": checks}


def _held(group, key):
    out, ref = group["out"], group["ref"]
    for name in ("params", "nu", "nu_i"):
        if f"{key}/{name}" in ref:
            np.testing.assert_allclose(out[f"{key}/{name}"],
                                       ref[f"{key}/{name}"], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{key} {name}")
    np.testing.assert_allclose(out[f"{key}/loss"], ref[f"{key}/loss"],
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("key", [r[0] for r in RUNS])
def test_mesh_train_round_matches_reference(group, key):
    _held(group, key)


def test_mesh_population_round_matches_reference(group):
    _held(group, "population")


def test_mesh_chunk_and_tail_equal_single_rounds(group):
    """A chunk of 2 and the length-polymorphic chunk's tail of 1 are the
    three rounds one by one, bit for bit."""
    out = group["out"]
    np.testing.assert_array_equal(out["chunk/params"], out["chunk/single"])
    np.testing.assert_allclose(out["chunk/loss"][:2],
                               out["flat/fedagrac/loss"], rtol=0, atol=0)


def test_mesh_sharded_leaves_are_sharded_on_every_rank(group):
    """After the rounds, every state leaf whose spec shards it holds only
    its share on every rank: weights and ν over ``model``, ν⁽ⁱ⁾ rows over
    ``data`` (the population's 4-row store too)."""
    for r, ch in enumerate(group["checks"]):
        assert not ch["fails"], (r, ch["fails"][:5])
        counts = ch["sharded_leaves"]
        assert counts["tree/fedagrac"] >= 9, counts
        assert counts["tree/fedavg"] >= 9, counts
        assert counts["flat/fedagrac"] == 3, counts       # params, ν, ν⁽ⁱ⁾
        assert counts["flat/fedavg"] == 1, counts
        assert counts["population"] >= 9, counts


def test_mesh_refuses_family_outside_scope(group):
    msg = str(group["out"]["refusal"])
    assert "A15" in msg and "granite-moe-1b-a400m" in msg, msg


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_main_reduced_on_one_rank_cpu_mesh(capsys):
    """``main --reduced --rounds 2`` on the one-rank CPU mesh prints the
    reference's line a round, chunked (a chunk of 2 and a tail of 1) as
    the single rounds are."""
    from repro_torch.launch import train
    import torch.distributed as tdist
    started = not tdist.is_initialized()
    try:
        argv = ["--reduced", "--device", "cpu", "--k-max", "2",
                "--param-layout", "flat"]
        train.main(argv + ["--rounds", "3"])
        single = capsys.readouterr().out.splitlines()
        train.main(argv + ["--rounds", "3", "--chunk-rounds", "2"])
        chunked = capsys.readouterr().out.splitlines()
        train.main(["--reduced", "--device", "cpu", "--rounds", "2",
                    "--k-max", "2"])
        tree = capsys.readouterr().out.splitlines()
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()
    line = re.compile(r"^round (\d+)/(\d+)  loss \d+\.\d{4}  kbar \d+\.\d{2}$")
    assert len(single) == 3 and len(tree) == 2, (single, tree)
    for i, ln in enumerate(single + tree):
        assert line.match(ln), ln
    assert chunked == single


def _counting_round():
    calls = []

    def round_fn(state, batches, k_steps, weights, lam):
        calls.append(float(lam))
        return ({"x": state["x"] + weights.sum() * k_steps.float().sum()},
                {"loss": state["x"].sum(), "kbar": k_steps.float().mean()})
    return round_fn, calls


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_length_polymorphic_chunk_runs_as_many_rounds_as_given(rounds):
    """``make_round_chunk(round_fn, None)`` runs one round a row of
    ``k_steps``, whatever their number; a fixed ``r`` refuses another
    count."""
    fn, calls = _counting_round()
    chunk = engine.make_round_chunk(fn, None)
    ks = torch.arange(rounds * 2, dtype=torch.int32).reshape(rounds, 2)
    state, met = chunk({"x": torch.zeros(3)}, {"t": torch.zeros(rounds, 1)},
                       ks, torch.ones(rounds, 2), [0.5] * rounds)
    assert calls == [0.5] * rounds and met["loss"].shape == (rounds,)
    with pytest.raises(ValueError, match="built for 2 rounds"):
        engine.make_round_chunk(fn, 2)({"x": torch.zeros(3)},
                                       {"t": torch.zeros(3, 1)},
                                       torch.zeros(3, 2), torch.ones(3, 2),
                                       [0.5] * 3)


QD, QM, QK = 6, 4, 8
Q_LR, Q_TOL = 0.01, (1e-6, 1e-7)          # tests/test_torch_golden.py


@pytest.mark.parametrize("algo_name", ["fedagrac", "fedavg"])
def test_length_polymorphic_chunk_matches_reference_on_quad_loss(algo_name):
    """The port's ``make_round_chunk(fn, None)`` (flat round) against the
    reference's (tree round) on the golden set's quadratic model: a chunk
    of 2 rounds then its tail of 1, each chunk length given only by its
    inputs, within the golden test's flat-vs-tree tolerance (ν⁽ⁱ⁾'s
    floor divided by η·K_min, as there)."""
    from repro.core import engine as jengine
    from repro.models.simple import quad_loss as jquad
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import flat, rounds
    from repro_torch.core.fedopt import get_algorithm
    from repro_torch.models.simple import quad_loss
    kw = dict(algorithm=algo_name, n_clients=QM, lr=Q_LR,
              calibration_rate=0.5)
    jalgo = jget_algorithm(algo_name, JFedConfig(**kw))
    talgo = get_algorithm(algo_name, FedConfig(**kw, param_layout="flat"))
    rng = np.random.default_rng(0)
    b = {"A": rng.normal(size=(3, QM, QK, QD, QD)).astype(np.float32),
         "b": rng.normal(size=(3, QM, QK, QD)).astype(np.float32),
         "c0": np.zeros((3, QM, QK), np.float32)}
    ks = np.array([[1, 3, 5, 8], [8, 5, 3, 1], [2, 2, 6, 4]], np.int32)
    w = np.broadcast_to(np.array([0.1, 0.2, 0.3, 0.4], np.float32), (3, QM))
    jchunk = jengine.make_round_chunk(
        jrounds.make_round(jquad, jalgo, lr=Q_LR, k_max=QK), None,
        donate=False)
    spec = flat.make_flat_spec({"x": torch.zeros(QD)})
    tchunk = engine.make_round_chunk(
        flat.make_flat_round(spec, quad_loss, talgo, lr=Q_LR, k_max=QK),
        None)
    jstate = jrounds.init_state({"x": jnp.zeros((QD,), jnp.float32)}, QM,
                                jalgo)
    state = rounds.init_state(torch.zeros(spec.p), QM, talgo)
    for sl in (slice(0, 2), slice(2, 3)):
        r = sl.stop - sl.start
        jstate, jmet = jchunk(
            jstate, {k: jnp.asarray(v[sl]) for k, v in b.items()},
            jnp.asarray(ks[sl]), jnp.asarray(w[sl]),
            jnp.full((r,), jalgo.lam, jnp.float32))
        state, met = tchunk(
            state, {k: torch.from_numpy(v[sl]) for k, v in b.items()},
            torch.from_numpy(ks[sl]), torch.from_numpy(w[sl].copy()),
            [talgo.lam] * r)
        assert met["loss"].shape == (r,)
        np.testing.assert_allclose(met["loss"].numpy(),
                                   np.asarray(jmet["loss"]), rtol=Q_TOL[0],
                                   atol=Q_TOL[1])
    rtol, atol = Q_TOL
    np.testing.assert_allclose(state["params"][:QD].numpy(),
                               np.asarray(jstate["params"]["x"]), rtol=rtol,
                               atol=atol)
    if "nu" in state:
        nu_atol = atol / (Q_LR * 1)
        np.testing.assert_allclose(state["nu"][:QD].numpy(),
                                   np.asarray(jstate["nu"]["x"]), rtol=rtol,
                                   atol=nu_atol)
        np.testing.assert_allclose(state["nu_i"][:, :QD].numpy(),
                                   np.asarray(jstate["nu_i"]["x"]),
                                   rtol=rtol, atol=nu_atol)
