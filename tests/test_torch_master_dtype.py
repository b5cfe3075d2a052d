"""The mixed-precision master buffer (``FedConfig.master_dtype``: bfloat16
leaves over a float32 flat buffer) in the port against the reference on
the CPU.

* ``make_flat_spec(tree, master_dtype=…)``: its fields equal the
  reference's; the views read bfloat16 and the helpers (``leaf_view``,
  ``view_tree``, ``ravel_rows``, ``flat_cotangent``, ``flat_apply``,
  ``flatten_state`` / ``unflatten_state``) equal the reference's bit for
  bit (a float32 → bfloat16 cast rounds to nearest even in both).
* One local step's cotangent of reduced gemma-2b's ``lm_loss`` in bfloat16
  (2 layers, d 64, vocab 256), and ``FederatedSimulation`` (one fedagrac
  round of that model) and ``BufferedAsyncSimulation`` (buffered fedagrac
  on the logistic model with bfloat16 weights and features) against the
  reference's.

Tolerances, in bfloat16 ulps of each leaf's largest entry (2⁻⁸ of it): the
two packages run the model's bfloat16 operations with other roundings
(XLA keeps float32 inside its fusions where PyTorch rounds each operation
to bfloat16), so the gradients differ by a few such ulps.  Measured on
the CPU: the local step's cotangent 3.3 ulps (STEP_ULPS 8); after one LM
round the update x⁺ − x, ν and ν⁽ⁱ⁾ 4.0, 4.0 and 4.5 ulps (ROUND_ULPS 12);
after the buffered run's six updates 0.5, 0.5 and 0.9.  The losses, of
bfloat16 logits, agree to LOSS_RTOL, one bfloat16 ulp (measured 1.9e-4
relative at most).  The reference's
model code runs after ``repro.dist.unset_mesh()`` (see
tests/test_torch_personalized.py)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.data import LMFederatedBatcher as JLMBatcher  # noqa: E402
from repro.data import lm_sequences as jlm_sequences  # noqa: E402
from repro.data.pipeline import FederatedBatcher as JBatcher  # noqa: E402
from repro.data.synthetic import Dataset as JDataset  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.fed import async_engine as jasync  # noqa: E402
from repro.fed import clock as jclock  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.data import (Dataset, FederatedBatcher,  # noqa: E402
                              LMFederatedBatcher)
from repro_torch.fed import (BufferedAsyncSimulation,  # noqa: E402
                             FederatedSimulation, clock)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

STEP_ULPS, ROUND_ULPS, LOSS_RTOL = 8.0, 12.0, 2.0 ** -8
SEQ, M_CLIENTS, BATCH = 16, 3, 2


@pytest.fixture(autouse=True)
def _no_global_mesh():
    dist.unset_mesh()


@pytest.fixture(scope="module")
def lm():
    """Reduced gemma-2b in bfloat16 in both packages, the same weights,
    and the reference's token streams."""
    dist.unset_mesh()
    cfg = dataclasses.replace(
        jreduced(jget_arch("gemma-2b"), n_layers=2, d_model=64, vocab=256),
        dtype="bfloat16")
    tcfg = dataclasses.replace(
        reduced(get_arch("gemma-2b"), n_layers=2, d_model=64, vocab=256),
        dtype="bfloat16")
    key = jax.random.PRNGKey(0)
    params = JM.init_params(key, cfg)
    streams = [jlm_sequences(jax.random.fold_in(key, i), 16, SEQ, cfg.vocab,
                             skew_topic=i) for i in range(M_CLIENTS)]
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                streams=streams)


def _ulps(got, want, scale, spec) -> float:
    """The largest |got − want| in bfloat16 ulps of ``scale``'s largest
    entry, leaf by leaf (the last axis is the flat one)."""
    worst = 0.0
    for off, size in zip(spec.offsets, spec.sizes):
        seg = slice(off, off + size)
        ulp = 2.0 ** -8 * float(np.abs(scale[..., seg]).max())
        worst = max(worst, float(np.abs(got[..., seg] - want[..., seg]).max())
                    / max(ulp, np.finfo(np.float32).tiny))
    return worst


# -- the spec and its helpers -------------------------------------------------


@pytest.mark.parametrize("master", [None, "float32"])
def test_spec_fields_equal_reference(lm, master):
    want = jflat.make_flat_spec(lm["params"], master_dtype=master)
    got = flat.make_flat_spec(lm["tparams"], master_dtype=master)
    assert got.shapes == want.shapes and got.sizes == want.sizes
    assert got.offsets == want.offsets
    assert (got.n, got.p) == (want.n, want.p)
    assert [str(d).replace("torch.", "") for d in got.dtypes] \
        == [str(d) for d in want.dtypes] == ["bfloat16"] * len(want.sizes)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype) \
        == (master or "bfloat16")
    # a mixed tree takes float32 without an override, the override with
    mixed = {"a": torch.zeros(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    assert flat.make_flat_spec(mixed).dtype == torch.float32
    assert flat.make_flat_spec(mixed, torch.bfloat16).dtype == torch.bfloat16


def test_views_and_helpers_equal_reference(lm):
    """bfloat16 views of a float32 master, bit for bit the reference's."""
    jspec = jflat.make_flat_spec(lm["params"], master_dtype="float32")
    spec = flat.make_flat_spec(lm["tparams"], master_dtype="float32")
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((2, spec.p)).astype(np.float32)
    rows[:, spec.n:] = 0
    trows = torch.from_numpy(rows)
    jtree = jflat.view_tree(jspec, jnp.asarray(rows), client_dims=1)
    ttree = flat.view_tree(spec, trows, client_dims=1)
    jleaves = jax.tree_util.tree_leaves(jtree)
    tleaves = [t for _, t in flat._leaves(ttree)]
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert t.shape == (2,) + spec.shapes[i]
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
        np.testing.assert_array_equal(
            flat.leaf_view(spec, trows[1], i).float().numpy(),
            np.asarray(jflat.leaf_view(jspec, jnp.asarray(rows[1]), i),
                       np.float32))
    # the write half: bfloat16 cotangents into the float32 master, and the
    # in-scan ravel of client rows
    cot = flat.flat_cotangent(spec, ttree, client_dims=1)
    assert cot.dtype == torch.float32
    np.testing.assert_array_equal(
        cot.numpy(), np.asarray(jflat.flat_cotangent(jspec, jtree,
                                                     client_dims=1)))
    np.testing.assert_array_equal(
        flat.ravel_rows(spec, ttree).numpy(),
        np.asarray(jflat.ravel_rows(jspec, jtree)))
    assert not cot[:, spec.n:].any()
    # flat_apply runs a tree function on the buffer's views
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    got = flat.flat_apply(spec, functools.partial(TM.forward, cfg=lm["tcfg"]),
                          trows[0], batch)[0]
    want = TM.forward(flat.view_tree(spec, trows[0]), batch, lm["tcfg"])[0]
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    # tree state ↔ flat state, as the reference's
    state = {"params": flat.unravel(spec, trows[0]),
             "nu": flat.unravel(spec, trows[1]), "nu_i": ttree,
             "round": torch.tensor(3)}
    jstate = {"params": jflat.unravel(jspec, jnp.asarray(rows[0])),
              "nu": jflat.unravel(jspec, jnp.asarray(rows[1])),
              "nu_i": jtree, "round": jnp.int32(3)}
    fs = flat.flatten_state(spec, state)
    jfs = jflat.flatten_state(jspec, jstate)
    assert sorted(fs) == sorted(jfs)
    for k in ("params", "nu", "nu_i"):
        assert fs[k].dtype == torch.float32
        np.testing.assert_array_equal(fs[k].numpy(), np.asarray(jfs[k]))
    back = flat.unflatten_state(spec, fs)
    for k in ("params", "nu", "nu_i"):
        for a, b in zip(flat._leaves(back[k]), flat._leaves(state[k])):
            assert a[1].dtype == torch.bfloat16 and torch.equal(a[1], b[1])
    assert back["round"] is state["round"]


# -- one local step, one round ------------------------------------------------


def test_local_step_cotangent_matches_reference(lm):
    """One local step's losses and (M, P) float32 cotangent rows of bfloat16
    leaves over a float32 master, two clients at other points."""
    jspec = jflat.make_flat_spec(lm["params"], master_dtype="float32")
    spec = flat.make_flat_spec(lm["tparams"], master_dtype="float32")
    x0 = np.asarray(jflat.ravel(jspec, lm["params"]))
    rng = np.random.default_rng(1)
    shift = (0.01 * rng.standard_normal(spec.p)).astype(np.float32)
    shift[spec.n:] = 0
    rows = np.stack([x0, x0 + shift])
    batch = {k: np.stack([np.asarray(s[k][:BATCH])
                          for s in lm["streams"][:2]])
             for k in ("tokens", "labels")}
    jvag = jax.vmap(jflat.flat_value_and_grad(
        jspec, functools.partial(JM.lm_loss, cfg=lm["cfg"])))
    jloss, jg = jvag(jnp.asarray(rows), jax.tree.map(jnp.asarray, batch))
    vag = flat.flat_value_and_grad(
        spec, functools.partial(TM.lm_loss, cfg=lm["tcfg"]))
    loss, g = vag(torch.from_numpy(rows),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert g.dtype == torch.float32 and not g[:, spec.n:].any()
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss),
                               rtol=LOSS_RTOL)
    jg = np.asarray(jg)
    assert _ulps(g.numpy(), jg, jg, spec) <= STEP_ULPS


def _lm_fed(cls):
    return cls(algorithm="fedagrac", n_clients=M_CLIENTS, k_mean=2, lr=0.1,
               calibration_rate=0.5, param_layout="flat",
               master_dtype="float32")


def test_fedagrac_round_matches_reference(lm):
    """``FederatedSimulation``: one fedagrac round of the bfloat16 LM over
    a float32 master in both packages, from the same weights and
    streams."""
    jsim = JSimulation(
        lambda p, b: JM.lm_loss(p, b, lm["cfg"]), lm["params"],
        _lm_fed(JFedConfig), JLMBatcher(lm["streams"], batch_size=BATCH),
        t_max=1)
    x0 = np.asarray(jsim.state["params"])
    jhist = jsim.run(1)
    tsim = FederatedSimulation(
        lambda p, b: TM.lm_loss(p, b, lm["tcfg"]), lm["tparams"],
        _lm_fed(FedConfig),
        LMFederatedBatcher([{k: np.asarray(v) for k, v in s.items()}
                            for s in lm["streams"]], batch_size=BATCH,
                           device="cpu"),
        t_max=1, device="cpu")
    assert tsim._spec.dtype == torch.float32
    np.testing.assert_array_equal(tsim.state["params"].numpy(), x0)
    thist = tsim.run(1)
    np.testing.assert_allclose(thist.loss, jhist.loss, rtol=LOSS_RTOL)
    spec = tsim._spec
    jp = np.asarray(jsim.state["params"])
    assert _ulps(tsim.state["params"].numpy() - x0, jp - x0, jp - x0,
                 spec) <= ROUND_ULPS
    for key in ("nu", "nu_i"):
        want = np.asarray(jsim.state[key])
        assert tsim.state[key].dtype == torch.float32
        assert _ulps(tsim.state[key].numpy(), want, want, spec) \
            <= ROUND_ULPS, key
    assert {t.dtype for _, t in flat._leaves(tsim.params)} \
        == {torch.bfloat16}


def test_buffered_master_dtype_matches_reference():
    """``BufferedAsyncSimulation``: buffered fedagrac (buffer 3 of 6
    clients, a lognormal clock) on the logistic model with bfloat16
    weights and features over a float32 master, six updates."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 8)).astype(np.float32)
    y = rng.integers(0, 4, 96).astype(np.int32)
    parts = [np.arange(16 * i, 16 * i + 16) for i in range(6)]
    params = {"w": (0.3 * rng.standard_normal((8, 4))).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    ks = rng.integers(1, 5, (50, 6)).astype(np.int32)
    kw = dict(algorithm="fedagrac", n_clients=6, buffer_size=3, lr=0.05,
              calibration_rate=0.5, weights="data", staleness_a=0.5,
              staleness_b=1, param_layout="flat", master_dtype="float32")
    jsim = jasync.BufferedAsyncSimulation(
        lambda p, b: jsimple.lr_loss(p, dict(b, x=b["x"].astype(
            jnp.bfloat16))),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
        JFedConfig(**kw),
        JBatcher(JDataset(jnp.asarray(x), jnp.asarray(y)), parts,
                 batch_size=5),
        k_schedule=ks, clock=jclock.make_clock(6, dist="lognormal",
                                               sigma=1.0, seed=3))
    x0 = np.asarray(jsim.state["params"])
    jhist = jsim.run(6)
    tsim = BufferedAsyncSimulation(
        lambda p, b: simple.lr_loss(p, dict(b, x=b["x"].bfloat16())),
        {k: torch.from_numpy(v).bfloat16() for k, v in params.items()},
        FedConfig(**kw),
        FederatedBatcher(Dataset(torch.from_numpy(x),
                                 torch.from_numpy(y).long()), parts,
                         batch_size=5, device="cpu"),
        k_schedule=ks, clock=clock.make_clock(6, dist="lognormal",
                                              sigma=1.0, seed=3),
        device="cpu")
    thist = tsim.run(6)
    np.testing.assert_allclose(thist.loss, jhist.loss, rtol=LOSS_RTOL)
    assert thist.sim_time == jhist.sim_time
    spec = tsim._spec
    jp = np.asarray(jsim.state["params"])
    assert _ulps(tsim.state["params"].numpy() - x0, jp - x0, jp - x0,
                 spec) <= ROUND_ULPS
    for key in ("nu", "nu_i"):
        want = np.asarray(jsim.state[key])
        assert _ulps(tsim.state[key].numpy(), want, want, spec) \
            <= ROUND_ULPS, key
