"""A PyTorch twin of examples/quickstart.py on the CPU: FedAvg, FedNova and
FedaGrac on the FedProx synthetic(1,1) task, 10 clients under the bimodal
schedule (nine at K = 2, one at K = 200), data weights — the port's
``FederatedSimulation`` against the JAX one with ``param_layout="flat"``.

Tolerances.  Both runs see bit-identical data and batches; they differ only
in float32 rounding (summation order in matmuls and gradient reductions,
about an ulp per local step, src/repro/core/flat.py lines 39-49), carried
through 200 local steps of the fast client per round.  ``History.loss`` is
held to rtol 1e-5 (a few ulps of a loss ~1 after hundreds of steps),
``History.kbar`` is the same float32 dot of the same inputs (rtol 1e-6),
and the eval accuracy over 4000 samples to within 2 samples (a prediction
can flip only where two logits tie to within that rounding).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import fedprox_synthetic as j_synthetic  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models.simple import lr_accuracy as j_lr_accuracy  # noqa: E402
from repro.models.simple import lr_loss as j_lr_loss  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data import FederatedBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.models.simple import lr_accuracy, lr_loss  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M, T, N_EVAL = 10, 3, 4000
LOSS_RTOL, KBAR_RTOL, METRIC_SAMPLES = 1e-5, 1e-6, 2


def _schedule():
    ks = np.full((1, M), 2, np.int32)
    ks[0, -1] = 200                       # one fast client
    return ks


def _config(cls, algo):
    return cls(algorithm=algo, n_clients=M, lr=0.02, calibration_rate=1.0,
               weights="data", param_layout="flat")


@pytest.fixture(scope="module")
def task():
    key = jax.random.PRNGKey(0)
    jdata, jparts = j_synthetic(key, M, alpha=1.0, beta=1.0)
    data, parts = fedprox_synthetic(
        int(jax.random.randint(key, (), 0, 2 ** 31 - 1)), M, alpha=1.0,
        beta=1.0)
    assert len(data) == N_EVAL
    return jdata, jparts, data, parts


def _port_sim(task, algo):
    _, _, data, parts = task
    batcher = FederatedBatcher(data, parts, batch_size=20, device="cpu")
    params = {"w": torch.zeros(60, 10), "b": torch.zeros(10)}
    return FederatedSimulation(
        lr_loss, params, _config(FedConfig, algo), batcher,
        eval_fn=lambda p: float(lr_accuracy(p, {"x": data.x, "y": data.y})),
        k_schedule=_schedule(), device="cpu")


@pytest.mark.parametrize("algo", ["fedavg", "fednova", "fedagrac"])
def test_quickstart_twin_matches_jax(task, algo):
    jdata, jparts, _, _ = task
    jsim = JSimulation(
        j_lr_loss, {"w": jnp.zeros((60, 10)), "b": jnp.zeros((10,))},
        _config(JFedConfig, algo), JBatcher(jdata, jparts, batch_size=20),
        eval_fn=lambda p: float(j_lr_accuracy(p, {"x": jdata.x,
                                                  "y": jdata.y})),
        k_schedule=_schedule())
    want = jsim.run(T)
    got = _port_sim(task, algo).run(T)
    np.testing.assert_allclose(got.loss, want.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.kbar, want.kbar, rtol=KBAR_RTOL)
    assert len(got.metric) == len(want.metric) == T
    np.testing.assert_allclose(np.array(got.metric) * N_EVAL,
                               np.array(want.metric) * N_EVAL,
                               atol=METRIC_SAMPLES)
    assert np.isfinite(got.loss).all() and len(got.wall) == T


def test_chunked_run_equals_per_round(task):
    """``chunk_rounds=3`` (one chunk, one host sync) runs the same rounds
    as the per-round path, so the results are the same bits."""
    per_round = _port_sim(task, "fedagrac")
    chunked = _port_sim(task, "fedagrac")
    h1 = per_round.run(T, eval_every=T, chunk_rounds=1)
    h3 = chunked.run(T, eval_every=T, chunk_rounds=3)
    assert h1.loss == h3.loss and h1.kbar == h3.kbar
    assert h1.metric == h3.metric and len(h3.metric) == 1
    for key in per_round.state:
        assert torch.equal(per_round.state[key], chunked.state[key]), key


def _counting_round(fail_at=None):
    """A round that adds 1 to ``x`` and raises on round ``fail_at``
    (numbered by its λ)."""
    def round_fn(state, batches, k, weights, lam):
        if lam == fail_at:
            raise FloatingPointError(f"round {lam}")
        return {"x": state["x"] + 1}, {"loss": state["x"].sum()}
    return round_fn


def _chunk_inputs(r):
    return ({"b": torch.zeros(r, 2, 1)}, torch.ones(r, 2, dtype=torch.int32),
            torch.full((r, 2), 0.5), list(range(r)))


@pytest.mark.parametrize("donate", [False, True])
def test_chunk_donation(donate):
    """A donated state dict is emptied by the chunk (the pre-chunk state is
    not held through it); an undonated one is left as it was."""
    from repro_torch.core import engine
    given = {"x": torch.zeros(3)}
    chunk = engine.make_round_chunk(_counting_round(), 3, donate=donate)
    state, metrics = chunk(given, *_chunk_inputs(3))
    assert torch.equal(state["x"], torch.full((3,), 3.0))
    assert metrics["loss"].tolist() == [0.0, 3.0, 6.0]
    assert (given == {}) if donate else torch.equal(given["x"],
                                                    torch.zeros(3))


def test_chunk_failure_keeps_last_finished_state(task):
    """When a round of a donated chunk raises, the dict holds the state
    after the last round that finished, and so does the simulation."""
    from repro_torch.core import engine
    given = {"x": torch.zeros(3)}
    chunk = engine.make_round_chunk(_counting_round(fail_at=2), 3,
                                    donate=True)
    with pytest.raises(FloatingPointError):
        chunk(given, *_chunk_inputs(3))
    assert torch.equal(given["x"], torch.full((3,), 2.0))

    def failing_round(state, *args):
        raise FloatingPointError("round 0")

    sim = _port_sim(task, "fedagrac")
    before = {k: v.clone() for k, v in sim.state.items()}
    sim._chunks[3] = engine.make_round_chunk(failing_round, 3, donate=True)
    with pytest.raises(FloatingPointError):
        sim.run(3, eval_every=3)
    assert sim.state.keys() == before.keys()
    for key in before:
        assert torch.equal(sim.state[key], before[key]), key
