"""The golden set on the port: its flat round on ``quad_loss`` against the
reference's tree round (``repro.core.rounds.make_round``, the round
tests/test_golden_equivalence.py pins to the frozen seed engine), on that
test's inputs — M = 4 clients, D = 6, K = [1, 3, 5, 8], weights [0.1, 0.2,
0.3, 0.4], lr 0.01, λ 0.5, the same numpy-made batches — for the nine
algorithms plus FedAvgM and FedAdam server steps, 3 chained rounds.

Tolerance: the flat-vs-tree one of the reference's own layouts
(src/repro/core/flat.py, lines 39-49; tests/test_flat_layout.py: rtol 1e-6,
atol 1e-7), since both rounds do the same float32 arithmetic in the same
order and differ only in where a multiply-add is contracted or a 6-term
dot is summed — about an ulp per local step.  ν and ν⁽ⁱ⁾ come from
``recover_avg_grad``, (x̃ − x⁽ⁱ⁾)/(η K_i): an ulp-scale difference in x is
divided by η·K_min = 0.01, so their absolute floor is ATOL / 0.01 = 1e-5
(the same reasoning as tests/test_torch_round.py's NU_TOL).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import ALGORITHMS  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.models.simple import quad_loss as j_quad_loss  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import flat, rounds  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.models.simple import quad_loss  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M, D, K_MAX, LR = 4, 6, 8, 0.01
W = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
KS = np.array([1, 3, 5, 8], np.int32)
RTOL, ATOL = 1e-6, 1e-7
NU_ATOL = ATOL / (LR * KS.min())

CASES = ([(a, "sgd", 1.0) for a in ALGORITHMS]
         + [(a, opt, lr) for a in ("fedavg", "fedagrac")
            for opt, lr in (("momentum", 0.7), ("adam", 0.1))])


def _batches(key=0):
    """tests/test_golden_equivalence.py's ``_batches``."""
    rng = np.random.default_rng(key)
    return {"A": rng.normal(size=(M, K_MAX, D, D)).astype(np.float32),
            "b": rng.normal(size=(M, K_MAX, D)).astype(np.float32),
            "c0": np.zeros((M, K_MAX), np.float32)}


def _algos(name, server_opt, server_lr):
    kw = dict(algorithm=name, n_clients=M, lr=LR, calibration_rate=0.5)
    ja = j_get_algorithm(name, JFedConfig(**kw))
    ta = get_algorithm(name, FedConfig(**kw, param_layout="flat"))
    rep = dict(server_opt=server_opt, server_lr=server_lr)
    return dataclasses.replace(ja, **rep), dataclasses.replace(ta, **rep)


@pytest.mark.parametrize("name,server_opt,server_lr", CASES)
def test_flat_round_on_quad_loss_holds_the_golden_set(name, server_opt,
                                                      server_lr):
    jalgo, talgo = _algos(name, server_opt, server_lr)
    b = _batches()
    jstate = jrounds.init_state({"x": jnp.zeros((D,), jnp.float32)}, M,
                                jalgo)
    jfn = jax.jit(jrounds.make_round(j_quad_loss, jalgo, lr=LR,
                                     k_max=K_MAX))
    params = {"x": torch.zeros(D)}
    spec = flat.make_flat_spec(params)
    state = rounds.init_state(flat.ravel(spec, params), M, talgo)
    fn = flat.make_flat_round(spec, quad_loss, talgo, lr=LR, k_max=K_MAX)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for _ in range(3):
        jstate, jmetrics = jfn(jstate, jax.tree.map(jnp.asarray, b),
                               jnp.asarray(KS), jnp.asarray(W))
        state, metrics = fn(state, tb, torch.from_numpy(KS),
                            torch.from_numpy(W))
    assert int(state["round"]) == int(jstate["round"]) == 3
    want = {"params": jstate["params"]["x"]}
    for key in ("nu", "server_m", "server_v"):
        if key in jstate:
            want[key] = jstate[key]["x"]
    if "nu_i" in jstate:
        want["nu_i"] = jstate["nu_i"]["x"]
    assert set(want) | {"round"} == set(state)
    for key, w in want.items():
        got = state[key].numpy()
        atol = NU_ATOL if key in ("nu", "nu_i") else ATOL
        np.testing.assert_allclose(got[..., :D], np.asarray(w), rtol=RTOL,
                                   atol=atol, err_msg=key)
        assert not got[..., D:].any(), f"{key}: the pad tail moved"
    for key in ("loss", "kbar"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
