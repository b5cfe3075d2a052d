"""The tree layout's paths in the port against the reference's on the
CPU: the simulation's synchronous and cohort chunks (host- and
device-sampled), the buffered engine, checkpoints and a reduced LM.

* ``FederatedSimulation`` with ``FedConfig()``'s default
  ``param_layout="tree"``: synchronous and cohort runs in chunks, host-
  and device-sampled (the cohort chunk with an int8 wire under dropout),
  against the reference's simulation on the same data.
* ``BufferedAsyncSimulation`` on the tree layout with an int8 uplink and
  broadcast and a trimmed-mean defense under ``scale_attack``.
* A tree state resumes bit for bit, and the port loads the reference's
  tree checkpoint (int8 wire, quarantine) bit for bit and continues as
  the reference does.
* Reduced gemma-2b (2 layers, d 64, vocab 256) through both packages' tree
  rounds, after ``repro.dist.unset_mesh()`` (C4).

Tolerances: tests/test_torch_robust.py's for the softmax rounds (rtol
1e-5 / atol 2e-6; ν, whose delta recovery divides by η·K_i, 1e-5) and
tests/test_torch_fed_lm.py's for the LM (params rtol 1e-5 / atol 2e-6,
loss rtol 1e-5).
"""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.checkpoint import serialize as jserialize  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.data import DeviceBatcher as JDeviceBatcher  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import LMFederatedBatcher as JLMBatcher  # noqa: E402
from repro.data import fedprox_synthetic as j_synthetic  # noqa: E402
from repro.fed import BufferedAsyncSimulation as JAsync  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.checkpoint import serialize  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.core.tree_util import tree_map  # noqa: E402
from repro_torch.data import (DeviceBatcher, FederatedBatcher,  # noqa: E402
                              LMFederatedBatcher, fedprox_synthetic,
                              lm_sequences)
from repro_torch.fed import (BufferedAsyncSimulation,  # noqa: E402
                             FederatedSimulation, scenarios)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import simple  # noqa: E402

PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_trees_close(got, want, key, tol):
    """A state entry of either layout: a tree of leaves by key, or one
    array; finiteness patterns equal, values close where finite."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for leaf in want:
            _assert_trees_close(got[leaf], want[leaf], f"{key}/{leaf}", tol)
        return
    w, g = np.asarray(want), _np(got)
    assert g.shape == w.shape, key
    if w.dtype.kind != "f":
        assert np.array_equal(g, w), key
        return
    fin = np.isfinite(w)
    assert np.array_equal(np.isfinite(g), fin), key
    np.testing.assert_allclose(g[fin], w[fin], **tol, err_msg=key)


def _assert_states_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        tol = (NU_TOL if key in ("nu", "nu_i", "ef_nu", "ef_down_nu")
               else PARAMS_TOL)
        _assert_trees_close(got[key], want[key], key, tol)


# ---------------------------------------------------------------------------
# the simulations' paths on FedConfig()'s default layout
# ---------------------------------------------------------------------------

SM = 8
# the numpy seed the reference's fedprox_synthetic draws from at PRNGKey(0)
DATA_SEED = 31327077
# at M = 8 the corrupt set of seed 0 is not empty at this rate (C2)
RATE = 0.4


@pytest.fixture(scope="module")
def data():
    return (fedprox_synthetic(DATA_SEED, SM, alpha=1.0, beta=1.0),
            j_synthetic(jax.random.PRNGKey(0), SM, alpha=1.0, beta=1.0))


def _fed_kw(**kw):
    return dict(dict(algorithm="fedagrac", n_clients=SM, lr=0.05,
                     calibration_rate=0.5, k_mean=4, k_var=2.0,
                     k_mode="random"), **kw)


def _port_sim(data, sampler="host", engine="sync", **kw):
    tdata, tparts = data[0]
    cls = {"sync": FederatedSimulation,
           "async": BufferedAsyncSimulation}[engine]
    bcls = {"host": FederatedBatcher, "device": DeviceBatcher}[sampler]
    sim = cls(simple.lr_loss, {"w": torch.zeros(60, 10),
                               "b": torch.zeros(10)},
              FedConfig(**_fed_kw(**kw)),
              bcls(tdata, tparts, batch_size=8, seed=0, device="cpu"),
              eval_fn=lambda p: float(simple.lr_accuracy(
                  p, {"x": tdata.x, "y": tdata.y})), device="cpu")
    assert sim.layout == "tree" and isinstance(sim.state["params"], dict)
    return sim


def _ref_sim(data, sampler="host", engine="sync", **kw):
    jdata, jparts = data[1]
    cls = {"sync": JSimulation, "async": JAsync}[engine]
    bcls = {"host": JBatcher, "device": JDeviceBatcher}[sampler]
    return cls(jsimple.lr_loss, {"w": jnp.zeros((60, 10)),
                                 "b": jnp.zeros((10,))},
               JFedConfig(**_fed_kw(**kw)), bcls(jdata, jparts, 8),
               eval_fn=lambda p: float(jsimple.lr_accuracy(
                   p, {"x": jdata.x, "y": jdata.y})))


def _assert_histories_close(th, jh, n_eval):
    for key in ("loss", "kbar", "mass"):
        np.testing.assert_allclose(getattr(th, key), getattr(jh, key),
                                   **PARAMS_TOL, err_msg=key)
    for key in ("dropped", "quarantined", "bytes_up", "bytes_down",
                "sim_time", "staleness"):
        assert getattr(th, key) == getattr(jh, key), key
    # accuracies to the sample
    np.testing.assert_allclose(th.metric, jh.metric, atol=1.5 / n_eval)


@pytest.mark.parametrize("sampler,kw", [
    ("host", {}),
    ("device", dict(algorithm="fednova")),
    ("host", dict(cohort_size=4, cohort_sampler="weighted")),
    ("device", dict(cohort_size=4, cohort_sampler="uniform",
                    compressor="int8", scenario="dropout",
                    dropout_rate=0.3))],
    ids=["sync-host", "sync-device", "cohort-host-weighted",
         "cohort-device-int8-dropout"])
def test_tree_simulation_matches_reference(data, sampler, kw):
    """``run(6, eval_every=3)``: chunks of three rounds."""
    jsim, tsim = _ref_sim(data, sampler, **kw), _port_sim(data, sampler,
                                                            **kw)
    jh, th = jsim.run(6, eval_every=3), tsim.run(6, eval_every=3)
    _assert_histories_close(th, jh, len(data[0][0].y))
    if kw.get("scenario") == "dropout":
        assert any(th.dropped)
    _assert_states_close(tsim.state, jsim.state)


def test_buffered_tree_run_with_wire_matches_reference(data):
    kw = dict(buffer_size=4, staleness="hinge", compressor="int8",
              broadcast_compressor="int8", scenario="scale_attack",
              scenario_rate=RATE, defense="trimmed_mean")
    assert scenarios._corrupt_set(SM, 0, RATE).any()
    jsim = _ref_sim(data, engine="async", **kw)
    tsim = _port_sim(data, engine="async", **kw)
    jh, th = jsim.run(6), tsim.run(6)
    _assert_histories_close(th, jh, len(data[0][0].y))
    _assert_states_close(tsim.state, jsim.state)
    _assert_trees_close(tsim._anchors, jsim._anchors, "anchors", PARAMS_TOL)


# ---------------------------------------------------------------------------
# checkpoints of a tree state
# ---------------------------------------------------------------------------

CKPT_KW = dict(compressor="int8", scenario="nan_inject", scenario_rate=RATE,
               defense="trimmed_mean", quarantine_window=3)


def test_tree_state_resumes_bit_for_bit(data, tmp_path):
    assert scenarios._corrupt_set(SM, 0, RATE).any()
    whole = _port_sim(data, "device", **CKPT_KW)
    whole.run(4, eval_every=2)
    path = str(tmp_path / "mid.msgpack")
    serialize.save(path, whole.state)
    h1 = whole.run(4, eval_every=2)
    resumed = _port_sim(data, "device", **CKPT_KW)
    resumed.state = serialize.load(path, resumed.state)
    h2 = resumed.run(4, eval_every=2)
    assert h1.loss == h2.loss and h1.quarantined == h2.quarantined
    assert h1.quarantined[-1] > 0
    a, b = (flat._leaves(s.state) for s in (whole, resumed))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (key, x), (_, y) in zip(a, b):
        # bit for bit, the NaN rows of the poisoned error feedback too
        assert x.dtype == y.dtype and np.array_equal(
            x.numpy(), y.numpy(), equal_nan=True), key
    assert int(resumed.state["round"]) == 8


def test_port_loads_the_reference_tree_checkpoint(data, tmp_path):
    """The reference's tree state (int8 error feedback and health vectors,
    flat on both layouts) loads into the port's bit for bit, and both
    continue alike."""
    jsim = _ref_sim(data, "device", **CKPT_KW)
    tsim = _port_sim(data, "device", **CKPT_KW)
    jsim.run(3, eval_every=3)
    path = str(tmp_path / "ref.msgpack")
    jserialize.save(path, jsim.state)
    tsim.state = serialize.load(path, tsim.state)
    assert isinstance(tsim.state["nu_i"], dict)
    got = flat._leaves(tsim.state)
    want = jax.tree_util.tree_leaves(jsim.state)
    assert len(got) == len(want)
    for (_, leaf), jleaf in zip(got, want):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    jh, th = jsim.run(3, eval_every=3), tsim.run(3, eval_every=3)
    _assert_histories_close(th, jh, len(data[0][0].y))
    _assert_states_close(tsim.state, jsim.state)


# ---------------------------------------------------------------------------
# an LM on the tree round
# ---------------------------------------------------------------------------

def test_reduced_gemma_tree_rounds_match_reference():
    """Two fedagrac rounds of the reference's ``_lm_setup`` model (reduced
    gemma-2b, 3 clients, batch 2, SEQ 16, K_i = 2, lr 0.1) on both
    packages' tree rounds, from the same weights and streams (the port's
    seeded ones, carried across as numpy: the parameter trees have the
    same structure)."""
    dist.unset_mesh()
    cut = {"n_layers": 2, "d_model": 64, "vocab": 256}
    cfg = jreduced(jget_arch("gemma-2b"), **cut)
    tcfg = reduced(get_arch("gemma-2b"), **cut)
    params = tree_map(lambda t: t.numpy(), TM.init_params(
        torch.Generator().manual_seed(0), tcfg))
    streams = [{k: v.numpy() for k, v in lm_sequences(
        i, 16, 16, cfg.vocab, skew_topic=i).items()} for i in range(3)]
    kw = dict(algorithm="fedagrac", n_clients=3, k_mean=2, lr=0.1,
              calibration_rate=0.5)
    jloss = functools.partial(JM.lm_loss, cfg=cfg)
    jsim = JSimulation(lambda p, b: jloss(p, b),
                       jax.tree.map(jnp.asarray, params), JFedConfig(**kw),
                       JLMBatcher([jax.tree.map(jnp.asarray, s)
                                   for s in streams], batch_size=2),
                       t_max=2)
    tloss = functools.partial(TM.lm_loss, cfg=tcfg)
    tsim = FederatedSimulation(
        lambda p, b: tloss(p, b), lm_params_from_numpy(params, "cpu"),
        FedConfig(**kw),
        LMFederatedBatcher(streams, batch_size=2, device="cpu"),
        t_max=2, device="cpu")
    jh, th = jsim.run(2, eval_every=2), tsim.run(2, eval_every=2)
    np.testing.assert_allclose(th.loss, jh.loss, rtol=1e-5)
    assert tsim.layout == "tree"
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jsim.params))
    got = [t.numpy() for _, t in flat._leaves(tsim.params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **PARAMS_TOL)
