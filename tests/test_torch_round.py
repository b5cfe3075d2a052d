"""The port's flat synchronous round against JAX ``make_flat_round`` — all
nine algorithms plus FedAvgM/FedAdam server steps, on lr and a narrow mlp,
from the same numpy-made parameters, batches and K_i — and a round state
carried from a JAX run into the port.

Tolerances.  The reference's own two layouts agree only to about 1 ulp per
local step (src/repro/core/flat.py, lines 39-49); the port adds another
order of summation in its matmuls and gradient reductions, so params are
held to float32 scale: rtol 1e-5 with an atol of 2e-6 over |x| ≲ 1.  ν and
ν⁽ⁱ⁾ come from ``recover_avg_grad``, which divides the cancellation x̃ − x⁽ⁱ⁾
by η·K_i: a 1-ulp (~1e-7) difference in x becomes ~1e-7/(η·K_min) =
1e-7/0.05 = 2e-6 in ν, and can add up over three chained rounds, so ν gets
atol 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import ALGORITHMS  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import flat, rounds  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M, B, D, C, HIDDEN = 4, 6, 8, 4, 16
LR, LAM = 0.05, 0.5
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [(a, "sgd") for a in ALGORITHMS] + [("fedagrac", "momentum"),
                                             ("fedagrac", "adam")]
MODELS = {"lr": (jsimple.lr_loss, simple.lr_loss,
                 {"w": (D, C), "b": (C,)}),
          "mlp": (jsimple.mlp_loss, simple.mlp_loss,
                  {"w1": (D, HIDDEN), "b1": (HIDDEN,), "w2": (HIDDEN, C),
                   "b2": (C,)})}


def _inputs(model, seed, n_rounds):
    """Parameters, per-client K_i ∈ 1..5, data weights and per-round
    batches, all numpy."""
    rng = np.random.default_rng(seed)
    params = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
              for k, s in MODELS[model][2].items()}
    k_steps = rng.integers(1, 6, M).astype(np.int32)
    k_steps[0], k_steps[1] = 1, 5            # a slow and a fast client
    w = rng.random(M).astype(np.float32) + 0.5
    weights = (w / w.sum()).astype(np.float32)
    batches = [{"x": rng.standard_normal((M, 5, B, D)).astype(np.float32),
                "y": rng.integers(0, C, (M, 5, B)).astype(np.int32)}
               for _ in range(n_rounds)]
    return params, k_steps, weights, batches


def _configs(algorithm, server_opt):
    kw = dict(algorithm=algorithm, n_clients=M, lr=LR, calibration_rate=LAM,
              server_opt=server_opt,
              server_lr=1.0 if server_opt == "sgd" else 0.1,
              param_layout="flat")
    return JFedConfig(**kw), FedConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_round(model, algorithm, server_opt):
    jfed, _ = _configs(algorithm, server_opt)
    algo = j_get_algorithm(algorithm, jfed)
    shapes = MODELS[model][2]
    spec = jflat.make_flat_spec({k: jnp.zeros(s) for k, s in shapes.items()})
    return spec, algo, jax.jit(jflat.make_flat_round(
        spec, MODELS[model][0], algo, lr=LR, k_max=5))


def _port_round(model, algorithm, server_opt, params):
    _, fed = _configs(algorithm, server_opt)
    algo = get_algorithm(algorithm, fed)
    spec = flat.make_flat_spec(params)
    return spec, algo, flat.make_flat_round(spec, MODELS[model][1], algo,
                                            lr=LR, k_max=5)


def _run_jax(model, algorithm, server_opt, params, k_steps, weights,
             batches, state=None):
    spec, algo, fn = _jax_round(model, algorithm, server_opt)
    if state is None:
        state = jrounds.init_state(
            jflat.ravel(spec, jax.tree.map(jnp.asarray, params)), M, algo)
    states = []
    for b in batches:
        state, _ = fn(state, jax.tree.map(jnp.asarray, b),
                      jnp.asarray(k_steps), jnp.asarray(weights),
                      jnp.float32(LAM))
        states.append(jax.tree.map(np.asarray, state))
    return states


def _run_port(model, algorithm, server_opt, params, k_steps, weights,
              batches, state=None):
    tparams = convert.params_from_numpy(params, "cpu")
    spec, algo, fn = _port_round(model, algorithm, server_opt, tparams)
    if state is None:
        state = rounds.init_state(flat.ravel(spec, tparams), M, algo)
    states = []
    for b in batches:
        state, _ = fn(state, convert.params_from_numpy(b, "cpu"),
                      torch.from_numpy(k_steps), torch.from_numpy(weights),
                      LAM)
        states.append(state)
    return states


def _assert_state_close(got, want):
    assert set(got) == set(want)
    assert int(got["round"]) == int(want["round"])
    np.testing.assert_allclose(got["params"].numpy(), want["params"],
                               **PARAMS_TOL)
    for key in ("nu", "nu_i"):
        if key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key], **NU_TOL)
    for key in ("server_m", "server_v"):
        if key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       **PARAMS_TOL)


@pytest.mark.parametrize("algorithm,server_opt", CASES)
@pytest.mark.parametrize("model", list(MODELS))
def test_flat_round_matches_jax(model, algorithm, server_opt):
    """One round, then the same state through two more chained rounds."""
    params, k_steps, weights, batches = _inputs(model, 11, 3)
    want = _run_jax(model, algorithm, server_opt, params, k_steps, weights,
                    batches)
    got = _run_port(model, algorithm, server_opt, params, k_steps, weights,
                    batches)
    _assert_state_close(got[0], want[0])
    _assert_state_close(got[2], want[2])
    assert not got[2]["params"][flat.make_flat_spec(
        convert.params_from_numpy(params, "cpu")).n:].any()


@pytest.mark.parametrize("algorithm,server_opt",
                         [("fedagrac", "adam"), ("scaffold", "momentum"),
                          ("fedprox", "sgd")])
def test_state_carried_from_jax_resumes(algorithm, server_opt):
    """Two rounds in JAX, the flat state carried across with
    ``convert.flat_state_from_numpy``, round 3 in both packages."""
    params, k_steps, weights, batches = _inputs("mlp", 12, 3)
    jstates = _run_jax("mlp", algorithm, server_opt, params, k_steps,
                       weights, batches[:2])
    carried = convert.flat_state_from_numpy(jstates[1], "cpu")
    assert carried["round"].dtype == torch.int32 and int(carried["round"]) == 2
    spec, _, _ = _jax_round("mlp", algorithm, server_opt)
    want = _run_jax("mlp", algorithm, server_opt, params, k_steps, weights,
                    batches[2:],
                    state=jax.tree.map(jnp.asarray, jstates[1]))
    got = _run_port("mlp", algorithm, server_opt, params, k_steps, weights,
                    batches[2:], state=carried)
    assert carried["params"].shape == (spec.p,)
    _assert_state_close(got[0], want[0])


def test_carrying_unported_state_raises():
    """The quarantine's health vectors carry across now that robust
    aggregation is ported; a key the port does not know still raises."""
    state = {"params": np.zeros(128, np.float32), "round": np.int32(0),
             "hz_until": np.arange(M, dtype=np.int32)}
    out = convert.flat_state_from_numpy(state, "cpu")
    assert out["hz_until"].dtype == torch.int32
    assert out["hz_until"].tolist() == list(range(M))
    state["unknown_store"] = np.zeros((M,), np.int32)
    with pytest.raises(NotImplementedError, match="unknown_store"):
        convert.flat_state_from_numpy(state, "cpu")
