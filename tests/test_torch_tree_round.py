"""The tree layout's rounds in the port (``repro_torch.core.rounds.make_round``,
``stages.make_cohort_round``) against the reference's on the CPU, and the
flat layout's leftovers (``track_nu="explicit"``, ``quantize_transmit``).

* The golden set: tests/test_golden_equivalence.py's inputs (M 4, D 6, K
  [1, 3, 5, 8], weights [0.1, 0.2, 0.3, 0.4], lr 0.01, λ 0.5, quad_loss)
  through the port's tree round and ``repro.core.rounds.make_round`` for
  the nine algorithms plus FedAvgM and FedAdam over 3 chained rounds, and
  the port's tree round against the port's flat round.
* A NaN gradient at a step past K_i (the reference's ``where(k < K_i,
  new, old)`` mask) never reaches the model.
* ``track_nu="explicit"`` and ``quantize_transmit`` on both layouts
  against the reference's round of the same layout, on the lr model (two
  leaves, so the int8 scale is per client AND leaf), for fedagrac and
  fedagrac_first with a prox term (a first-gradient selector reading the
  prox-augmented gradient); the explicit accumulator against the delta
  recovery; ``quantize_int8_flat`` against the tree quantization.
* int8, topk+int8 (with an int8 broadcast) on the tree round, through
  the flat view table, against the reference's tree round;
  ``nan_inject`` under a trimmed-mean defense with a quarantine and
  ``scale_attack`` under krum, the corrupt set checked non-empty first
  (ROADMAP C2), the ``quarantined`` metric equal.
* The cohort tree round, a cohort that draws a client twice included (the
  reference keeps the last occurrence's row: ``last_occurrence``, C15),
  with ν decay and int8.

The buffered tree engine, the simulation's paths, checkpoints and an LM
are tests/test_torch_tree_paths.py's.

Tolerances: the reference's own flat-vs-tree ones (tests/test_flat_layout.py:
rtol 1e-6, atol 1e-7) for the golden set, whose rounds do the same float32
arithmetic in the same order and differ where a multiply-add is contracted
or a short dot summed; ν and ν⁽ⁱ⁾ come from ``recover_avg_grad``'s division
by η·K_min = 0.01, so their absolute floor is 1e-5 (tests/test_torch_golden.py).
The lr-model rounds (softmax, 4 rounds) take tests/test_torch_robust.py's
rtol 1e-5 / atol 2e-6, ν 1e-5; the explicit-vs-delta check 1e-4, the
recovery's cancellation (x̃ − x⁽ⁱ⁾)/(η K_i) at lr 0.1 over ulps of x.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import robust as jrobust  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core import stages as jstages  # noqa: E402
from repro.core.fedopt import ALGORITHMS  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.fed import scenarios as jscn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import (compress, flat, robust, rounds,  # noqa: E402
                              stages)
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.fed import scenarios  # noqa: E402
from repro_torch.kernels.calibrated_update import ops as cu_ops  # noqa: E402
from repro_torch.models import simple  # noqa: E402

M, D, K_MAX, LR = 4, 6, 8, 0.01
W = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
KS = np.array([1, 3, 5, 8], np.int32)
RTOL, ATOL = 1e-6, 1e-7
NU_ATOL = ATOL / (LR * KS.min())
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)

CASES = ([(a, "sgd", 1.0) for a in ALGORITHMS]
         + [(a, opt, lr) for a in ("fedavg", "fedagrac")
            for opt, lr in (("momentum", 0.7), ("adam", 0.1))])


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _golden_batches(key=0):
    """tests/test_golden_equivalence.py's ``_batches``."""
    rng = np.random.default_rng(key)
    return {"A": rng.normal(size=(M, K_MAX, D, D)).astype(np.float32),
            "b": rng.normal(size=(M, K_MAX, D)).astype(np.float32),
            "c0": np.zeros((M, K_MAX), np.float32)}


def _algos(name, server_opt="sgd", server_lr=1.0, **fed_kw):
    kw = dict(algorithm=name, n_clients=M, lr=LR, calibration_rate=0.5,
              **fed_kw)
    rep = dict(server_opt=server_opt, server_lr=server_lr)
    return (dataclasses.replace(j_get_algorithm(name, JFedConfig(**kw)),
                                **rep),
            dataclasses.replace(get_algorithm(name, FedConfig(**kw)), **rep))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_trees_close(got, want, key, rtol, atol):
    """A state entry of either layout: a tree of leaves by key, or one
    array; finiteness patterns equal, values close where finite."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for leaf in want:
            _assert_trees_close(got[leaf], want[leaf], f"{key}/{leaf}", rtol,
                                atol)
        return
    w, g = np.asarray(want), _np(got)
    assert g.shape == w.shape, key
    if w.dtype.kind != "f":
        assert np.array_equal(g, w), key
        return
    fin = np.isfinite(w)
    assert np.array_equal(np.isfinite(g), fin), key
    np.testing.assert_allclose(g[fin], w[fin], rtol=rtol, atol=atol,
                               err_msg=key)


def _assert_states_close(got: dict, want: dict, nu_atol=NU_TOL["atol"],
                         rtol=PARAMS_TOL["rtol"], atol=PARAMS_TOL["atol"]):
    assert sorted(got) == sorted(want)
    for key in want:
        a = (nu_atol if key in ("nu", "nu_i", "ef_nu", "ef_down_nu")
             else atol)
        _assert_trees_close(got[key], want[key], key, rtol, a)


# ---------------------------------------------------------------------------
# the golden set
# ---------------------------------------------------------------------------

def _golden_run(name, server_opt, server_lr, layout="tree", rounds_=3,
                batches=None, reference=True):
    """``rounds_`` rounds of the port's round (``layout``) and, with
    ``reference``, the reference's tree round: (reference state, metrics,
    port state, metrics)."""
    jalgo, talgo = _algos(name, server_opt, server_lr)
    b = batches or _golden_batches()
    jstate = jm = None
    if reference:
        jstate = jrounds.init_state({"x": jnp.zeros((D,), jnp.float32)}, M,
                                    jalgo)
        jfn = jax.jit(jrounds.make_round(jsimple.quad_loss, jalgo, lr=LR,
                                         k_max=K_MAX))
    params = {"x": torch.zeros(D)}
    if layout == "tree":
        state = rounds.init_state(params, M, talgo)
        fn = rounds.make_round(simple.quad_loss, talgo, lr=LR, k_max=K_MAX)
    else:
        spec = flat.make_flat_spec(params)
        state = rounds.init_state(flat.ravel(spec, params), M, talgo)
        fn = flat.make_flat_round(spec, simple.quad_loss, talgo, lr=LR,
                                  k_max=K_MAX)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for _ in range(rounds_):
        if reference:
            jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, b),
                             jnp.asarray(KS), jnp.asarray(W))
        state, tm = fn(state, tb, torch.from_numpy(KS), torch.from_numpy(W))
    return jstate, jm, state, tm


@pytest.mark.parametrize("name,server_opt,server_lr", CASES)
def test_tree_round_holds_the_golden_set(name, server_opt, server_lr):
    before = dict(cu_ops.launches)
    jstate, jm, state, tm = _golden_run(name, server_opt, server_lr)
    assert cu_ops.launches == before
    assert int(state["round"]) == int(jstate["round"]) == 3
    assert isinstance(state["params"], dict)
    _assert_states_close(state, jstate, NU_ATOL, RTOL, ATOL)
    for key in ("loss", "kbar"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name,server_opt,server_lr", CASES)
def test_tree_round_matches_the_flat_round(name, server_opt, server_lr):
    _, _, tree, tm = _golden_run(name, server_opt, server_lr,
                                 reference=False)
    _, _, flat_state, fm = _golden_run(name, server_opt, server_lr, "flat",
                                       reference=False)
    assert sorted(tree) == sorted(flat_state)
    for key, v in tree.items():
        if key == "round":
            assert int(v) == int(flat_state[key])
            continue
        got = flat_state[key][..., :D].numpy()
        atol = NU_ATOL if key in ("nu", "nu_i") else ATOL
        np.testing.assert_allclose(v["x"].numpy(), got, rtol=RTOL,
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(float(tm["loss"]), float(fm["loss"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["fedagrac"])
def test_nan_gradient_of_a_masked_step_does_not_leak(name):
    """Steps k ≥ K_i see NaN data: the masked update keeps the old leaves,
    as the reference's ``where`` does, and the round stays finite and
    equal to the reference's."""
    b = _golden_batches()
    for i, k in enumerate(KS):
        b["b"][i, k:] = np.nan
    jstate, jm, state, tm = _golden_run(name, "sgd", 1.0, rounds_=2,
                                        batches=b)
    assert all(bool(torch.isfinite(v).all()) for v in
               (state["params"]["x"], *([state["nu"]["x"]]
                                        if "nu" in state else [])))
    _assert_states_close(state, jstate, NU_ATOL, RTOL, ATOL)


# ---------------------------------------------------------------------------
# track_nu="explicit" and quantize_transmit on both layouts (lr model)
# ---------------------------------------------------------------------------

LM, LD, LC, LB, LK = 5, 7, 3, 4, 4


@pytest.fixture(scope="module")
def lr_inputs():
    rng = np.random.default_rng(3)
    params = {"w": (0.5 * rng.standard_normal((LD, LC))).astype(np.float32),
              "b": (0.5 * rng.standard_normal(LC)).astype(np.float32)}
    ks = np.array([1, 4, 2, 3, 4], np.int32)
    w = np.array([0.3, 0.1, 0.2, 0.25, 0.15], np.float32)
    batches = [{"x": rng.standard_normal((LM, LK, LB, LD)).astype(np.float32),
                "y": rng.integers(0, LC, (LM, LK, LB)).astype(np.int32)}
               for _ in range(4)]
    return params, ks, w, batches


def _lr_algos(name, prox):
    kw = dict(algorithm=name, n_clients=LM, lr=0.1, calibration_rate=0.5)
    ja, ta = (j_get_algorithm(name, JFedConfig(**kw)),
              get_algorithm(name, FedConfig(**kw)))
    if prox:
        ja, ta = (dataclasses.replace(a, prox_mu=0.1) for a in (ja, ta))
    return ja, ta


def _lr_rounds(inputs, jfn, js, tfn, ts, n=4):
    _, ks, w, batches = inputs
    for b in batches[:n]:
        js, jm = jfn(js, jax.tree.map(jnp.asarray, b), jnp.asarray(ks),
                     jnp.asarray(w), jnp.float32(0.5))
        ts, tm = tfn(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                     torch.from_numpy(ks), torch.from_numpy(w), 0.5)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **PARAMS_TOL)
    return js, ts


@pytest.mark.parametrize("layout", ["tree", "flat"])
@pytest.mark.parametrize("mode", ["explicit", "quantize_transmit"])
@pytest.mark.parametrize("name,prox", [("fedagrac", False),
                                       ("fedagrac_first", True)])
def test_explicit_nu_and_quantized_transmit_match_reference(
        layout, mode, name, prox, lr_inputs):
    params = lr_inputs[0]
    jalgo, talgo = _lr_algos(name, prox)
    kw = (dict(track_nu="explicit") if mode == "explicit"
          else dict(quantize_transmit=True))
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    if layout == "tree":
        jfn = jax.jit(jrounds.make_round(jsimple.lr_loss, jalgo, lr=0.1,
                                         k_max=LK, **kw))
        js = jrounds.init_state(jp, LM, jalgo)
        tfn = rounds.make_round(simple.lr_loss, talgo, lr=0.1, k_max=LK,
                                **kw)
        ts = rounds.init_state(tp, LM, talgo)
    else:
        jspec, spec = jflat.make_flat_spec(jp), flat.make_flat_spec(tp)
        jfn = jax.jit(jflat.make_flat_round(jspec, jsimple.lr_loss, jalgo,
                                            lr=0.1, k_max=LK, **kw))
        js = jrounds.init_state(jflat.ravel(jspec, jp), LM, jalgo)
        tfn = flat.make_flat_round(spec, simple.lr_loss, talgo, lr=0.1,
                                   k_max=LK, **kw)
        ts = rounds.init_state(flat.ravel(spec, tp), LM, talgo)
    js, ts = _lr_rounds(lr_inputs, jfn, js, tfn, ts)
    _assert_states_close(ts, js)


def test_explicit_nu_agrees_with_the_delta_recovery(lr_inputs):
    """The explicit accumulator and the delta recovery are two routes to
    the same ν̄⁽ⁱ⁾ (the reference's use of ``explicit``), on both
    layouts."""
    params = lr_inputs[0]
    _, talgo = _lr_algos("fedagrac", False)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    out = {}
    for layout in ("tree", "flat"):
        for track in ("delta", "explicit"):
            if layout == "tree":
                fn = rounds.make_round(simple.lr_loss, talgo, lr=0.1,
                                       k_max=LK, track_nu=track)
                st = rounds.init_state(tp, LM, talgo)
            else:
                fn = flat.make_flat_round(spec, simple.lr_loss, talgo,
                                          lr=0.1, k_max=LK, track_nu=track)
                st = rounds.init_state(flat.ravel(spec, tp), LM, talgo)
            _, ks, w, batches = lr_inputs
            st, _ = fn(st, {k: torch.from_numpy(v)
                            for k, v in batches[0].items()},
                       torch.from_numpy(ks), torch.from_numpy(w), 0.5)
            nu_i = st["nu_i"]
            out[layout, track] = (nu_i if layout == "flat"
                                  else flat.ravel(spec, nu_i, 1))
    ref = out["tree", "explicit"]
    for key, v in out.items():
        np.testing.assert_allclose(v.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=str(key))


def test_quantize_int8_flat_is_the_tree_quantization(lr_inputs):
    """One scale per client and leaf: the flat segment-wise quantization
    equals the tree one leaf for leaf, bit for bit, pad tail zero."""
    params = lr_inputs[0]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    rng = np.random.default_rng(5)
    tree = {"w": torch.from_numpy(rng.standard_normal((LM, LD, LC))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((LM, LC))
                                  .astype(np.float32) * 100)}
    q_tree = stages.quantize_int8(tree)
    q_flat = flat.quantize_int8_flat(spec, flat.ravel(spec, tree, 1))
    assert torch.equal(flat.ravel(spec, q_tree, 1), q_flat)
    assert not q_flat[:, spec.n:].any()
    jq = jstages.quantize_int8(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                            tree))
    for k in tree:
        np.testing.assert_array_equal(q_tree[k].numpy(), np.asarray(jq[k]))


# ---------------------------------------------------------------------------
# the wire on the tree round: compression, attacks, defenses
# ---------------------------------------------------------------------------

WM, WK = 8, 3


@pytest.fixture(scope="module")
def wire_inputs():
    rng = np.random.default_rng(0)
    params = {"w": (0.5 * rng.standard_normal((LD, LC))).astype(np.float32),
              "b": (0.5 * rng.standard_normal(LC)).astype(np.float32)}
    ks = rng.integers(1, WK + 1, WM).astype(np.int32)
    w = (rng.random(WM) + 0.5).astype(np.float32)
    w /= w.sum()
    batches = [{"x": rng.standard_normal((WM, WK, LB, LD)).astype(np.float32),
                "y": rng.integers(0, LC, (WM, WK, LB)).astype(np.int32)}
               for _ in range(4)]
    return params, ks, w, batches


def _wire_kw(comp="none", attack="baseline", defense="none", qw=0,
             algorithm="fedagrac", down="none"):
    return dict(algorithm=algorithm, n_clients=WM, lr=0.05,
                calibration_rate=0.5, scenario=attack, scenario_rate=0.3,
                scenario_magnitude=5.0, defense=defense,
                quarantine_window=qw, quarantine_z=1.0, compressor=comp,
                broadcast_compressor=down)


def _wire_rounds(kw, inputs, cohorts=None, nu_decay=0.0):
    """The reference's tree round and the port's on the same config, four
    rounds (cohort rounds given ``cohorts``); their states and metrics."""
    params, ks, w, batches = inputs
    jfed, fed = JFedConfig(**kw), FedConfig(**kw)
    jalgo = j_get_algorithm(kw["algorithm"], jfed)
    talgo = get_algorithm(kw["algorithm"], fed)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jspec, spec = jflat.make_flat_spec(jp), flat.make_flat_spec(tp)
    jcomp = jcompress.CompressionConfig.from_fed(jfed)
    comp = compress.CompressionConfig.from_fed(fed)
    jrb, rb = (jrobust.RobustConfig.from_fed(jfed),
               robust.RobustConfig.from_fed(fed))
    atk = scenarios.make_scenario(fed)
    if atk is not None and atk.corrupts_payload:
        assert atk.hit.any(), "an empty corrupt set tests nothing (C2)"
    jwire = dict(compression=jcomp, spec=jspec, robust=jrb,
                 attack=jscn.make_scenario(jfed))
    wire = dict(compression=comp, spec=spec, robust=rb, attack=atk)
    js = jrounds.init_state(jp, WM, jalgo, compression=jcomp, spec=jspec,
                            robust=jrb)
    ts = rounds.init_state(tp, WM, talgo, compression=comp, spec=spec,
                           robust=rb)
    if cohorts is None:
        jfn = jax.jit(jrounds.make_round(jsimple.lr_loss, jalgo, lr=0.05,
                                         k_max=WK, **jwire))
        tfn = rounds.make_round(simple.lr_loss, talgo, lr=0.05, k_max=WK,
                                **wire)
    else:
        jfn = jax.jit(jstages.make_cohort_round(
            jsimple.lr_loss, jalgo, lr=0.05, k_max=WK, nu_decay=nu_decay,
            **jwire))
        tfn = stages.make_cohort_round(simple.lr_loss, talgo, lr=0.05,
                                       k_max=WK, nu_decay=nu_decay, **wire)
    jms, tms = [], []
    for j, b in enumerate(batches):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        if cohorts is None:
            js, jm = jfn(js, jax.tree.map(jnp.asarray, b), jnp.asarray(ks),
                         jnp.asarray(w), jnp.float32(0.5))
            ts, tm = tfn(ts, tb, torch.from_numpy(ks), torch.from_numpy(w),
                         0.5)
        else:
            ids = cohorts[j]
            cw = (w[ids] / w[ids].sum() * 0.9).astype(np.float32)
            cb = {k: v[: len(ids)] for k, v in b.items()}
            js, jm = jfn(js, jax.tree.map(jnp.asarray, cb),
                         jnp.asarray(ids, jnp.int32),
                         jnp.asarray(ks[ids]), jnp.asarray(cw),
                         jnp.float32(0.5))
            last = stages.last_occurrence(ids)
            ts, tm = tfn(ts, {k: v[: len(ids)] for k, v in tb.items()},
                         torch.from_numpy(ids.astype(np.int64)),
                         torch.from_numpy(ks[ids]), torch.from_numpy(cw),
                         0.5, last=torch.from_numpy(last))
        jms.append(jax.tree.map(np.asarray, jm))
        tms.append(tm)
    return js, ts, jms, tms


@pytest.mark.parametrize("comp,down,algorithm", [
    ("topk+int8", "int8", "fedagrac"), ("int8", "none", "fedavg")])
def test_compressed_tree_round_matches_reference(comp, down, algorithm,
                                                 wire_inputs):
    from repro_torch.kernels.quantize import ops as q_ops
    before = dict(q_ops.launches)
    js, ts, jms, tms = _wire_rounds(_wire_kw(comp, algorithm=algorithm,
                                             down=down), wire_inputs)
    assert q_ops.launches == before          # CPU tensors launch nothing
    assert isinstance(ts["params"], dict)
    assert ts["ef_up"].shape == (WM, flat.make_flat_spec(
        ts["params"]).p)
    _assert_states_close(ts, js)


@pytest.mark.parametrize("attack,defense,qw", [
    ("nan_inject", "trimmed_mean", 4), ("scale_attack", "krum", 0)])
def test_attacked_defended_tree_round_matches_reference(attack, defense, qw,
                                                        wire_inputs):
    js, ts, jms, tms = _wire_rounds(
        _wire_kw("int8", attack, defense, qw), wire_inputs)
    _assert_states_close(ts, js)
    for jm, tm in zip(jms, tms):
        assert float(tm["quarantined"]) == float(jm["quarantined"])
    assert all(bool(torch.isfinite(v).all())
               for v in ts["params"].values())
    if qw and attack == "nan_inject":
        # every corrupt client is quarantined from its first report on
        bad = float(scenarios._corrupt_set(WM, 0, 0.3).sum())
        assert [float(m["quarantined"]) for m in tms] == [0.0] + [bad] * 3


@pytest.mark.parametrize("comp,nu_decay,algorithm", [
    ("none", 0.0, "fednova"), ("int8", 0.3, "fedagrac")])
def test_cohort_tree_round_matches_reference(comp, nu_decay, algorithm,
                                             wire_inputs):
    """Cohorts of 4 of the 8 clients; round 1 draws client 5 twice (the
    weighted sampler's draw with replacement): the reference keeps its
    last occurrence's row."""
    cohorts = [np.array(c, np.int32) for c in
               ([0, 3, 6, 7], [5, 1, 5, 2], [4, 0, 2, 6], [1, 3, 5, 7])]
    js, ts, jms, tms = _wire_rounds(_wire_kw(comp, algorithm=algorithm),
                                    wire_inputs, cohorts, nu_decay)
    _assert_states_close(ts, js)
    for jm, tm in zip(jms, tms):
        np.testing.assert_allclose(float(tm["mass"]), float(jm["mass"]),
                                   rtol=1e-6)
