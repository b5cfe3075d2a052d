"""Byzantine-robust aggregation in the port (``repro_torch.core.robust``)
and the attacked, defended synchronous round, against the JAX package on
the CPU.

* Each defense of ``DEFENSES`` on padded ``(B, P)`` rows with dead and
  NaN rows, odd and even live counts (the medians average the two middle
  values, as ``jnp.nanmedian``; ``torch.median`` would not), against the
  reference's: rows within 1e-6, masks equal.
* ``_renorm``: Σw preserved over the survivors, and the all-dead no-op
  (original weights, zeroed rows), equal to the reference's.
* ``_health_update`` with repeated ids: counters accumulate, the EWMA and
  quarantine rows keep the last occurrence's values — equal to the
  reference's ``.at[].add`` / ``.at[].set`` on the CPU, in place and not.
* ``defense="none"`` with ``quarantine_window=0`` is no stage: the round is
  bit-identical to the unbracketed one.
* ``make_flat_round`` under each attack × {none, clip, median,
  trimmed_mean, krum} with a quarantine (and each defense without one),
  and under NaN/scale attacks on
  the int8 and top-k wire (the dequantized NaN/Inf rows dropped, the
  error-feedback rows' finiteness pattern the reference's), against the
  reference's flat round on the same state over 4 rounds: params, ν, ν⁽ⁱ⁾,
  the residuals and the health vectors within tests/test_torch_round.py's
  tolerances, every finiteness pattern and integer vector equal, the
  ``quarantined`` metric equal.  Every attack's corrupt set is checked
  non-empty first (ROADMAP C2).
* A reference state with live health vectors carries across through
  ``convert.flat_state_from_numpy`` and continues as the reference does.
* The undefended ``nan_inject`` run raises ``FloatingPointError`` at its
  eval, in both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import robust as jrobust  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.fed import scenarios as jscn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import compress, flat, robust, rounds  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.fed import scenarios  # noqa: E402
from repro_torch.models import simple  # noqa: E402

M, B, D, N_CLASSES, K_MAX = 10, 5, 8, 4, 3
LR, LAM = 0.05, 0.5
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)
ATTACKS = ("nan_inject", "inf_inject", "scale_attack", "sign_flip",
           "garbage")
DEFENSES = ("none", "clip", "median", "trimmed_mean", "krum")


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


def _assert_states_close(got: dict, want: dict) -> None:
    """Float stores within the tolerances where both are finite, with the
    same finiteness pattern; integer stores equal."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        if w.dtype.kind != "f":
            assert np.array_equal(g, w), key
            continue
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), fin), key
        tol = PARAMS_TOL if key in ("params", "hz_mean", "hz_var") \
            else NU_TOL
        np.testing.assert_allclose(g[fin], w[fin], **tol, err_msg=key)


# ---------------------------------------------------------------------------
# the defenses and pipeline pieces
# ---------------------------------------------------------------------------

def _rows(b=7, p=256, n=250, seed=0, nan_rows=(2,), dead=(4,)):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((b, p)).astype(np.float32)
    rows[:, n:] = 0.0
    mask = np.ones(b, bool)
    mask[list(dead)] = False
    rows[list(nan_rows), 3] = np.nan
    mask[list(nan_rows)] = False
    # the defenses' entry invariant: dead rows' data zeroed
    rows[~mask] = 0.0
    return rows, mask


@pytest.mark.parametrize("defense", DEFENSES)
@pytest.mark.parametrize("dead", [(4,), (4, 5), (), (0, 1, 3, 4, 5, 6)])
@pytest.mark.parametrize("clip_norm", [0.0, 3.0])
def test_defense_matches_reference(defense, dead, clip_norm):
    rows, mask = _rows(dead=dead)
    cfg = dict(defense=defense, clip_norm=clip_norm, trim_frac=0.2,
               krum_f=1)
    jfn = jrobust.DEFENSES[defense](jrobust.RobustConfig(**cfg), 250)
    tfn = robust.DEFENSES[defense](robust.RobustConfig(**cfg), 250)
    jr, jm = jfn(jnp.asarray(rows), jnp.asarray(mask))
    tr, tm = tfn(torch.from_numpy(rows), torch.from_numpy(mask))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)


def test_medians_average_the_two_middle_values():
    vals = torch.tensor([[1.0], [4.0], [2.0], [10.0], [0.0]])
    mask = torch.tensor([True, True, True, True, False])
    assert robust._nanmedian(vals, mask).item() == 3.0     # (2 + 4) / 2
    assert robust._nanmedian(vals, torch.zeros(5, dtype=torch.bool)
                             ).item() == 0.0


@pytest.mark.parametrize("alive", ["some", "none"])
def test_renorm_preserves_mass_and_all_dead_is_a_no_op(alive):
    rows, _ = _rows(nan_rows=())
    w = np.random.default_rng(1).random(7).astype(np.float32)
    mask = (np.arange(7) % 2 == 0) if alive == "some" else np.zeros(7, bool)
    jr, jw = jrobust._renorm(jnp.asarray(rows), jnp.float32,
                             jnp.asarray(w), jnp.asarray(mask))
    tr, tw = robust._renorm(torch.from_numpy(rows), torch.float32,
                            torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    if alive == "some":
        np.testing.assert_allclose(tw.sum().item(), w.sum(), rtol=1e-6)
        assert not tw[~torch.from_numpy(mask)].any()
    else:
        assert np.array_equal(tw.numpy(), w) and not tr.any()


@pytest.mark.parametrize("in_place", [False, True])
def test_health_update_with_repeated_ids(in_place):
    rng = np.random.default_rng(3)
    cfg = dict(defense="none", quarantine_window=3, quarantine_z=0.5,
               quarantine_nonfinite=2)
    m = 6
    state = {"hz_nonfinite": rng.integers(0, 2, m).astype(np.int32),
             "hz_mean": rng.random(m).astype(np.float32),
             "hz_var": (0.1 * rng.random(m)).astype(np.float32),
             "hz_count": np.array([0, 3, 5, 1, 4, 3], np.int32),
             "hz_until": np.array([0, 0, 4, 0, 0, 0], np.int32)}
    ids = np.array([1, 4, 1, 2, 4, 0], np.int64)
    rows = (3.0 * rng.standard_normal((6, 64))).astype(np.float32)
    finite = np.array([True, False, True, True, True, False])
    rows[~finite] = 0.0
    quar = np.array([False, False, False, True, False, False])
    r = 3
    jnew = {}
    jrobust._health_update(jrobust.RobustConfig(**cfg),
                           {k: jnp.asarray(v) for k, v in state.items()},
                           jnew, jnp.asarray(ids, jnp.int32),
                           jnp.asarray(rows), jnp.asarray(finite),
                           jnp.asarray(quar), jnp.int32(r))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tnew = {}
    from repro_torch.core import stages
    robust._health_update(robust.RobustConfig(**cfg), tstate, tnew,
                          torch.from_numpy(ids), torch.from_numpy(rows),
                          torch.from_numpy(finite), torch.from_numpy(quar),
                          torch.tensor(r, dtype=torch.int32),
                          last=torch.from_numpy(
                              stages.last_occurrence(ids)),
                          in_place=in_place)
    for key in robust.ROBUST_STATE_KEYS:
        want, got = np.asarray(jnew[key]), tnew[key].numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        else:
            assert np.array_equal(got, want), key
        assert (tnew[key] is tstate[key]) == in_place
    # client 1 reported twice: both reports counted
    assert tnew["hz_count"][1] == state["hz_count"][1] + 2


# ---------------------------------------------------------------------------
# the attacked, defended synchronous round
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_inputs():
    rng = np.random.default_rng(0)
    params = {"w": (0.5 * rng.standard_normal((D, N_CLASSES))
                    ).astype(np.float32),
              "b": (0.5 * rng.standard_normal(N_CLASSES)).astype(np.float32)}
    k_row = rng.integers(1, K_MAX + 1, M).astype(np.int32)
    w = (rng.random(M) + 0.5).astype(np.float32)
    w /= w.sum()
    batches = [{"x": rng.standard_normal((M, K_MAX, B, D)).astype(np.float32),
                "y": rng.integers(0, N_CLASSES, (M, K_MAX, B)).astype(
                    np.int32)} for _ in range(4)]
    return params, k_row, w, batches


def _kw(attack, defense, comp="none", qw=4):
    return dict(algorithm="fedagrac", n_clients=M, lr=LR,
                calibration_rate=LAM, param_layout="flat",
                scenario=attack, scenario_rate=0.3, scenario_magnitude=5.0,
                defense=defense, quarantine_window=qw, quarantine_z=1.0,
                compressor=comp)


def _jax_round(kw, params):
    jfed = JFedConfig(**kw)
    algo = j_get_algorithm(kw["algorithm"], jfed)
    jp = jax.tree.map(jnp.asarray, params)
    spec = jflat.make_flat_spec(jp)
    rb = jrobust.RobustConfig.from_fed(jfed)
    comp = jcompress.CompressionConfig.from_fed(jfed)
    fn = jax.jit(jflat.make_flat_round(
        spec, jsimple.lr_loss, algo, lr=LR, k_max=K_MAX, compression=comp,
        robust=rb, attack=jscn.make_scenario(jfed)))
    state = jrounds.init_state(jflat.ravel(spec, jp), M, algo,
                               compression=comp, spec=spec, robust=rb)
    return fn, state


def _port_round(kw, params):
    fed = FedConfig(**kw)
    algo = get_algorithm(kw["algorithm"], fed)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    spec = flat.make_flat_spec(tp)
    rb = robust.RobustConfig.from_fed(fed)
    comp = compress.CompressionConfig.from_fed(fed)
    atk = scenarios.make_scenario(fed)
    if atk is not None and atk.corrupts_payload:
        assert atk.hit.any(), "an empty corrupt set tests nothing (C2)"
    fn = flat.make_flat_round(spec, simple.lr_loss, algo, lr=LR,
                              k_max=K_MAX, compression=comp, robust=rb,
                              attack=atk)
    state = rounds.init_state(flat.ravel(spec, tp), M, algo,
                              compression=comp, spec=spec, robust=rb)
    return fn, state


def _run_both(kw, round_inputs, n_rounds=4):
    params, k_row, w, batches = round_inputs
    jfn, js = _jax_round(kw, params)
    tfn, ts = _port_round(kw, params)
    jms, tms = [], []
    for b in batches[:n_rounds]:
        js, jm = jfn(js, jax.tree.map(jnp.asarray, b), jnp.asarray(k_row),
                     jnp.asarray(w), jnp.float32(LAM))
        ts, tm = tfn(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                     torch.from_numpy(k_row), torch.from_numpy(w), LAM)
        jms.append(jax.tree.map(np.asarray, jm))
        tms.append(tm)
    return js, ts, jms, tms


@pytest.mark.parametrize("defense", DEFENSES)
@pytest.mark.parametrize("attack", ATTACKS)
def test_defended_sync_round_matches_reference(attack, defense,
                                               round_inputs):
    js, ts, jms, tms = _run_both(_kw(attack, defense), round_inputs)
    _assert_states_close(ts, js)
    for jm, tm in zip(jms, tms):
        assert float(tm["quarantined"]) == float(jm["quarantined"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **PARAMS_TOL)
    if defense != "none":
        assert torch.isfinite(ts["params"]).all()
    if attack in ("nan_inject", "inf_inject"):
        # the attacker is quarantined from its first report on
        assert [float(m["quarantined"]) for m in tms] == [0.0, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("defense", DEFENSES[1:])
@pytest.mark.parametrize("attack", ["nan_inject", "scale_attack"])
def test_defense_without_quarantine_matches_reference(attack, defense,
                                                      round_inputs):
    """A defense with ``quarantine_window=0``: no health vectors, no
    ``quarantined`` count beyond 0, the same round as the reference's."""
    js, ts, jms, tms = _run_both(_kw(attack, defense, qw=0), round_inputs)
    assert not any(k.startswith("hz_") for k in ts)
    _assert_states_close(ts, js)
    assert [float(m["quarantined"]) for m in tms] == [0.0] * 4


@pytest.mark.parametrize("comp", ["int8", "topk"])
@pytest.mark.parametrize("attack", ["nan_inject", "inf_inject",
                                    "scale_attack"])
def test_attacks_on_the_compressed_wire_match_reference(attack, comp,
                                                        round_inputs):
    js, ts, jms, tms = _run_both(_kw(attack, "trimmed_mean", comp),
                                 round_inputs)
    _assert_states_close(ts, js)
    if attack != "scale_attack" and comp == "int8":
        # the poisoned row's scale is non-finite, so is its dequantized
        # row and the attacker's error-feedback row
        bad = torch.from_numpy(scenarios._corrupt_set(M, 0, 0.3))
        assert not torch.isfinite(ts["ef_up"][bad]).any()
        assert torch.isfinite(ts["ef_up"][~bad]).all()


def test_none_defense_without_quarantine_is_the_plain_round(round_inputs):
    assert robust.RobustConfig.from_fed(
        FedConfig(defense="none", quarantine_window=0)) is None
    params, k_row, w, batches = round_inputs
    kw = dict(_kw("baseline", "none", qw=0))
    plain = dict(kw, scenario="baseline")
    fa, sa = _port_round(kw, params)
    fb, sb = _port_round(plain, params)
    for b in batches[:2]:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        sa, ma = fa(sa, tb, torch.from_numpy(k_row), torch.from_numpy(w))
        sb, mb = fb(sb, tb, torch.from_numpy(k_row), torch.from_numpy(w))
    assert sorted(sa) == sorted(sb) and "quarantined" not in ma
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_reference_health_state_carries_across(round_inputs):
    params, k_row, w, batches = round_inputs
    kw = _kw("nan_inject", "median")
    jfn, js = _jax_round(kw, params)
    for b in batches[:2]:
        js, _ = jfn(js, jax.tree.map(jnp.asarray, b), jnp.asarray(k_row),
                    jnp.asarray(w), jnp.float32(LAM))
    assert int(np.asarray(js["hz_until"]).max()) > 0
    tfn, _ = _port_round(kw, params)
    ts = convert.flat_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for b in batches[2:]:
        js, jm = jfn(js, jax.tree.map(jnp.asarray, b), jnp.asarray(k_row),
                     jnp.asarray(w), jnp.float32(LAM))
        ts, tm = tfn(ts, {k: torch.from_numpy(v) for k, v in b.items()},
                     torch.from_numpy(k_row), torch.from_numpy(w), LAM)
        assert float(tm["quarantined"]) == float(jm["quarantined"]) == 1.0
    _assert_states_close(ts, js)


def test_undefended_nan_inject_raises_at_eval():
    from repro.data import FederatedBatcher as JBatcher
    from repro.data.synthetic import Dataset as JDataset
    from repro.fed import FederatedSimulation as JSimulation
    from repro_torch.data import Dataset, FederatedBatcher
    from repro_torch.fed import FederatedSimulation
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, D)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, 200).astype(np.int32)
    parts = np.array_split(np.arange(200), M)
    kw = dict(algorithm="fedagrac", n_clients=M, lr=LR, k_mean=2,
              calibration_rate=LAM, param_layout="flat",
              scenario="nan_inject", scenario_rate=0.3)
    assert scenarios._corrupt_set(M, 0, 0.3).any()
    params = {"w": np.zeros((D, N_CLASSES), np.float32),
              "b": np.zeros(N_CLASSES, np.float32)}
    batch = {"x": x, "y": y}
    tsim = FederatedSimulation(
        simple.lr_loss, {k: torch.from_numpy(v) for k, v in params.items()},
        FedConfig(**kw),
        FederatedBatcher(Dataset(torch.from_numpy(x),
                                 torch.from_numpy(y).long()), parts,
                         batch_size=4, device="cpu"),
        eval_fn=lambda p: float(simple.lr_loss(
            p, {k: torch.from_numpy(v) for k, v in batch.items()})),
        device="cpu")
    jsim = JSimulation(
        jsimple.lr_loss, jax.tree.map(jnp.asarray, params),
        JFedConfig(**kw),
        JBatcher(JDataset(jnp.asarray(x), jnp.asarray(y)), parts,
                 batch_size=4),
        eval_fn=lambda p: float(jsimple.lr_loss(
            p, jax.tree.map(jnp.asarray, batch))))
    for sim in (jsim, tsim):
        with pytest.raises(FloatingPointError, match="non-finite"):
            sim.run(2)
