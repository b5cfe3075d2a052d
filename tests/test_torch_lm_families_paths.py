"""The MoE, MLA and xLSTM families on the round's other paths, in the port
against the JAX package on the CPU, on ``test_torch_lm_families_round``'s
cut (``reduced(..., n_layers=2, d_model=64, vocab=256)``, 3 clients,
batch 2, SEQ 16, K_i = 2, lr 0.1, λ 0.5):

* ``LMFederatedBatcher``'s cohort draws against the reference's;
* granite-moe-1b-a400m on the cohort round (a uniform cohort of 2), the
  buffered round (buffer 2, polynomial staleness, a lognormal clock, 3
  updates) and the device-sampled sync round (``DeviceLMBatcher``), each
  on the flat and on the tree layout, as the reference's
  ``tests/test_flat_apply.py`` pins them flat against tree;
* granite-moe and deepseek-v2-lite in bfloat16 over the float32 master;
* ``torch.func.vmap(torch.func.grad(lm_loss))`` of the two MoE models.

Tolerances.  The float32 paths are held to ``test_torch_fed_lm``'s
PARAMS_RTOL / PARAMS_ATOL and LOSS_RTOL.  The bfloat16 runs' masters to
BF16_PARAMS_ATOL and their losses to BF16_LOSS_RTOL: the reference's own
run moves that far (7.3e-3, 9.2e-4 relative) when every initial weight
moves by one ulp of its dtype, the largest of three draws for each model;
the port ends 1.8e-3 (granite) and 2.4e-3 (deepseek) from it.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.data import DeviceLMBatcher as JDeviceLMBatcher  # noqa: E402
from repro.data import LMFederatedBatcher as JLMBatcher  # noqa: E402
from repro.fed import BufferedAsyncSimulation as JAsync  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.data import DeviceLMBatcher, LMFederatedBatcher  # noqa: E402
from repro_torch.fed import (BufferedAsyncSimulation,  # noqa: E402
                             FederatedSimulation)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_torch_fed_lm import (BATCH, LOSS_RTOL, M_CLIENTS,  # noqa: E402
                               PARAMS_ATOL, PARAMS_RTOL, _np_streams,
                               _setup)
from test_torch_lm_families_round import _client_batches, _fed  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

# the reference against itself, every initial weight moved by one ulp of
# its dtype: the masters up to 7.3e-3 apart, the losses 9.2e-4 (six draws)
BF16_PARAMS_ATOL, BF16_LOSS_RTOL = 7.5e-3, 2.0 ** -8
GRANITE = "granite-moe-1b-a400m"


@pytest.fixture(autouse=True)
def _no_global_mesh():
    dist.unset_mesh()


def _bf16_setup(arch):
    """``_setup``'s cut in bfloat16: the reference's bfloat16 init."""
    cfg, tcfg, streams, _ = _setup(16, arch=arch)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    return cfg, tcfg, streams, JM.init_params(jax.random.PRNGKey(0), cfg)


def _run_both(arch, layout, engine="sync", device_sampler=False, steps=2,
              bf16=False, **kw):
    """The same run in both packages: ``engine`` "sync" (``steps`` rounds
    in one chunk) or "buffered" (``steps`` updates); ``bf16``: the cut in
    bfloat16."""
    cfg, tcfg, streams, params = (_bf16_setup(arch) if bf16
                                  else _setup(16, arch=arch))
    jbatcher = (JDeviceLMBatcher if device_sampler else JLMBatcher)(
        streams, batch_size=BATCH)
    tbatcher = (DeviceLMBatcher if device_sampler else LMFederatedBatcher)(
        _np_streams(streams), batch_size=BATCH, device="cpu")
    jloss = functools.partial(JM.lm_loss, cfg=cfg)
    tloss = functools.partial(TM.lm_loss, cfg=tcfg)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    if engine == "sync":
        jsim = JSimulation(lambda p, b: jloss(p, b), params,
                           _fed(JFedConfig, layout, **kw), jbatcher,
                           t_max=steps)
        tsim = FederatedSimulation(lambda p, b: tloss(p, b), tparams,
                                   _fed(FedConfig, layout, **kw), tbatcher,
                                   t_max=steps, device="cpu")
        runs = [s.run(steps, eval_every=steps) for s in (jsim, tsim)]
    else:
        jsim = JAsync(lambda p, b: jloss(p, b), params,
                      _fed(JFedConfig, layout, **kw), jbatcher)
        tsim = BufferedAsyncSimulation(lambda p, b: tloss(p, b), tparams,
                                       _fed(FedConfig, layout, **kw),
                                       tbatcher, device="cpu")
        runs = [s.run(steps) for s in (jsim, tsim)]
    assert tsim.layout == layout
    return jsim, tsim, runs[0], runs[1]


def _leaf_pairs(tsim, jsim):
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jsim.params))
    got = flat._leaves(tsim.params)
    assert len(got) == len(want)
    return [(path, g, w) for (path, g), w in zip(got, want)]


def test_lm_batcher_cohort_rows_equal_reference():
    """``LMFederatedBatcher``'s cohort draws — each client from its own
    ``(seed, t, i)`` stream, whatever the cohort — equal the reference's
    bit for bit, one round and a chunk; ``client_rows`` gathers the
    sequences of the clients it is given (the buffered engine's rows)."""
    _, _, streams, _ = _setup(16)
    jb = JLMBatcher(streams, batch_size=BATCH, seed=3)
    tb = LMFederatedBatcher(_np_streams(streams), batch_size=BATCH, seed=3,
                            device="cpu")
    cohorts = np.array([[2, 0], [1, 1]])
    one, want = tb.cohort_batches(4, cohorts[0], 3), \
        jb.cohort_batches(4, cohorts[0], 3)
    chunk, jchunk = tb.chunk_cohort_batches(4, cohorts, 3), \
        jb.chunk_cohort_batches(4, cohorts, 3)
    for key in ("tokens", "labels"):
        assert one[key].shape == (2, 3, BATCH, 16)
        np.testing.assert_array_equal(one[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(chunk[key].numpy(),
                                      np.asarray(jchunk[key]))
    idx = np.stack([tb.client_indices(4, 1, 3), tb.client_indices(4, 2, 3)])
    rows = tb.client_rows(np.array([1, 2]), idx)
    for j, i in enumerate((1, 2)):
        np.testing.assert_array_equal(
            rows["tokens"][j].numpy(), np.asarray(streams[i]["tokens"])[idx[j]])


PATHS = {
    "cohort": dict(cohort_size=2, cohort_sampler="uniform"),
    "buffered": dict(engine="buffered", steps=3, buffer_size=2,
                     staleness="poly", speed_dist="lognormal",
                     speed_sigma=0.5),
    "device": dict(device_sampler=True),
}


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_granite_moe_paths_match_reference(path, layout):
    """granite-moe on the cohort, buffered and device-sampled rounds, each
    layout against the reference's same layout: losses to LOSS_RTOL, the
    final model to PARAMS_RTOL / PARAMS_ATOL."""
    jsim, tsim, jh, th = _run_both(GRANITE, layout, **PATHS[path])
    np.testing.assert_allclose(th.loss, jh.loss, rtol=LOSS_RTOL)
    if path == "buffered":
        assert th.sim_time == jh.sim_time
    for leaf, g, w in _leaf_pairs(tsim, jsim):
        assert g.shape == w.shape, leaf
        np.testing.assert_allclose(g.numpy(), w, rtol=PARAMS_RTOL,
                                   atol=PARAMS_ATOL, err_msg=str(leaf))


@pytest.mark.parametrize("arch", [GRANITE, "deepseek-v2-lite-16b"])
def test_moe_bf16_master_rounds_match_reference(arch):
    """Two flat fedagrac rounds in bfloat16 over the float32 master: the
    master stays float32, the leaves bfloat16 (the router float32, as the
    reference's); the master within BF16_PARAMS_ATOL of the reference's,
    the losses within BF16_LOSS_RTOL."""
    jsim, tsim, jh, th = _run_both(
        arch, "flat", bf16=True, master_dtype="float32")
    np.testing.assert_allclose(th.loss, jh.loss, rtol=BF16_LOSS_RTOL)
    assert tsim._spec.dtype == tsim.state["params"].dtype == torch.float32
    np.testing.assert_allclose(tsim.state["params"].numpy(),
                               np.asarray(jsim.state["params"]),
                               rtol=0, atol=BF16_PARAMS_ATOL)
    for leaf, g, w in _leaf_pairs(tsim, jsim):
        assert str(g.dtype) == f"torch.{w.dtype}", leaf


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_moe_loss_gradient_runs_under_vmap(arch):
    """``torch.func.vmap(torch.func.grad(lm_loss))`` over three clients'
    batches, as the round batches clients: the first-choice counts of the
    aux term once took ``F.one_hot``, which vmap refuses (it reads its
    input's values).  Row i equals client i's own gradient exactly, the
    aux term equals the reference's, and the vmapped losses equal the
    reference's ``jax.vmap`` ones within LOSS_RTOL."""
    cfg, tcfg, streams, params = _setup(16, arch=arch)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = _client_batches(streams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = functools.partial(TM.lm_loss, cfg=tcfg)
    grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        tparams, tbatch)
    for i in range(M_CLIENTS):
        own = torch.func.grad(loss)(tparams, {k: v[i]
                                              for k, v in tbatch.items()})
        for (path, g), (_, w) in zip(flat._leaves(grads), flat._leaves(own)):
            assert torch.equal(g[i], w), path
    losses = torch.func.vmap(loss, in_dims=(None, 0))(tparams, tbatch)
    jlosses = jax.vmap(lambda b: JM.lm_loss(params, b, cfg))(
        jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_RTOL)
    # the aux term alone, under vmap, against the reference's
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M_CLIENTS, 8, tcfg.d_model)).astype(np.float32)
    w = np.array(params["segments"][0]["moe"]["router"])[0, 0]
    got = torch.func.vmap(lambda xx: tmoe.route(torch.from_numpy(w), xx,
                                                tcfg.moe.top_k)[2])(
        torch.from_numpy(x))
    want = jax.vmap(lambda xx: jmoe.route(jnp.asarray(w), xx,
                                          cfg.moe.top_k)[2])(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
