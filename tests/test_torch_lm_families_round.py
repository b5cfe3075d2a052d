"""The MoE, MLA, sliding-window and xLSTM families through the federated
round in the port against the JAX package on the CPU.

Each family is cut as the reference's ``_lm_setup`` cuts gemma-2b
(``reduced(..., n_layers=2, d_model=64, vocab=256)``; 3 clients, batch 2,
K_i = 2, lr 0.1, λ 0.5) and run for two fedagrac rounds through
``FederatedSimulation`` on the flat and on the tree layout, in both
packages, from the reference's weights and token streams:

* granite-moe-1b-a400m: the cut's 4 experts, top-2, the float32 router
  and the aux term under ``torch.func.vmap``;
* deepseek-v2-lite-16b: MLA (Dqk = head dim + 16 ≠ Dv) and MoE with
  shared experts;
* gemma3-12b at SEQ 32, above the cut's window of 16, so the local
  layers' band bites;
* xlstm-125m: the mLSTM's parallel form and the sLSTM's time loop.

Tolerances.  The MoE, MLA and window families are held to
``test_torch_fed_lm``'s PARAMS_RTOL / PARAMS_ATOL and LOSS_RTOL (the
same float32 operations summed in other orders; measured ≤ 6e-8 apart).
xLSTM's parameters are held to XLSTM_PARAMS_ATOL (ROADMAP C23): the
reference's own two rounds move by up to 1.29e-4 when every initial
weight moves by one ulp (four draws, fedagrac and fedavg, against 1.2e-7
for gemma-2b), and the port ends 4.9e-5 from it.  xLSTM's gradient at
one point is held to XLSTM_GRAD_RTOL of each leaf's largest entry: the
port's vmapped gradient is 2.9e-6 of it from the reference's, and the
reference's own gradient moves by 8.7e-6 of it under a one-ulp move of
the weights.

The cohort, buffered and device-sampled paths, bf16 over the float32
master, and the MoE gradients under vmap are in
``test_torch_lm_families_paths.py``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.data import LMFederatedBatcher as JLMBatcher  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.data import LMFederatedBatcher  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_fed_lm import (BATCH, LOSS_RTOL, M_CLIENTS,  # noqa: E402
                               PARAMS_ATOL, PARAMS_RTOL, _np_streams,
                               _setup)
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

# ROADMAP C23: the reference against itself under a one-ulp move of the
# initial weights, the largest of four draws and two algorithms
XLSTM_PARAMS_ATOL = 1.3e-4
XLSTM_GRAD_RTOL = 1e-5

FAMILIES = {"granite-moe-1b-a400m": 16, "deepseek-v2-lite-16b": 16,
            "gemma3-12b": 32, "xlstm-125m": 16}


@pytest.fixture(autouse=True)
def _no_global_mesh():
    dist.unset_mesh()


def _fed(cls, layout, **kw):
    return cls(**{**dict(algorithm="fedagrac", n_clients=M_CLIENTS,
                         k_mean=2, lr=0.1, calibration_rate=0.5,
                         param_layout=layout), **kw})


def _run_both(arch, layout, rounds=2):
    cfg, tcfg, streams, params = _setup(FAMILIES[arch], arch=arch)
    jloss = functools.partial(JM.lm_loss, cfg=cfg)
    jsim = JSimulation(lambda p, b: jloss(p, b), params,
                       _fed(JFedConfig, layout),
                       JLMBatcher(streams, batch_size=BATCH), t_max=rounds)
    jhist = jsim.run(rounds, eval_every=rounds)
    tloss = functools.partial(TM.lm_loss, cfg=tcfg)
    tsim = FederatedSimulation(
        lambda p, b: tloss(p, b),
        lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
        _fed(FedConfig, layout),
        LMFederatedBatcher(_np_streams(streams), batch_size=BATCH,
                           device="cpu"),
        t_max=rounds, device="cpu")
    before = dict(fa_ops.launches)
    thist = tsim.run(rounds, eval_every=rounds)
    assert fa_ops.launches == before          # CPU tensors launch nothing
    assert tsim.layout == layout
    return jsim, jhist, tsim, thist


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_rounds_match_reference(arch, layout):
    """Two fedagrac rounds of each family on each layout: the round losses
    to LOSS_RTOL, every leaf of the final model to PARAMS_RTOL plus
    PARAMS_ATOL (xLSTM: XLSTM_PARAMS_ATOL, ROADMAP C23)."""
    jsim, jhist, tsim, thist = _run_both(arch, layout)
    atol = XLSTM_PARAMS_ATOL if arch == "xlstm-125m" else PARAMS_ATOL
    np.testing.assert_allclose(thist.loss, jhist.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(thist.kbar, jhist.kbar, rtol=1e-7)
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jsim.params))
    got = flat._leaves(tsim.params)
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=PARAMS_RTOL, atol=atol,
                                   err_msg=str(path))


def _client_batches(streams):
    return {k: np.stack([np.asarray(s[k][:BATCH]) for s in streams])
            for k in ("tokens", "labels")}


def test_xlstm_vmapped_gradient_matches_reference():
    """One local step's gradient of reduced xlstm-125m, three clients at
    the same point: the port's ``flat_value_and_grad`` (``torch.func.vmap``
    over the clients) against ``jax.vmap(jax.grad)`` of the reference's
    loss on its flat views, leaf by leaf within XLSTM_GRAD_RTOL of the
    leaf's largest entry (measured 2.9e-6; the reference's own gradient
    moves by 8.7e-6 under a one-ulp move of the weights, ROADMAP C23).
    The vmapped rows equal each client's un-vmapped gradient exactly, so
    vmap adds nothing to the round's gap."""
    cfg, tcfg, streams, params = _setup(16, arch="xlstm-125m")
    batch = _client_batches(streams)
    jspec = jflat.make_flat_spec(params)
    rows = jnp.stack([jflat.ravel(jspec, params)] * M_CLIENTS)

    def one(row, b):
        return JM.lm_loss(jflat.view_tree(jspec, row), b, cfg)
    want = np.asarray(jax.jit(jax.vmap(jax.grad(one)))(
        rows, jax.tree.map(jnp.asarray, batch)))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    spec = flat.make_flat_spec(tparams)
    tl = functools.partial(TM.lm_loss, cfg=tcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, got = flat.flat_value_and_grad(spec, tl)(
        torch.stack([flat.ravel(spec, tparams)] * M_CLIENTS), tbatch)
    got = got.numpy()
    assert not got[:, spec.n:].any()
    for i in range(M_CLIENTS):
        leaves = [t.detach().requires_grad_()
                  for _, t in flat._leaves(tparams)]
        own = torch.autograd.grad(
            tl(flat._tree(spec.treedef, leaves),
               {k: v[i] for k, v in tbatch.items()}), leaves)
        np.testing.assert_array_equal(
            got[i], flat.ravel(spec, flat._tree(spec.treedef, own)).numpy())
    for path, off, size in zip((p for p, _ in flat._leaves(tparams)),
                               spec.offsets, spec.sizes):
        seg = slice(off, off + size)
        scale = np.abs(want[:, seg]).max()
        assert np.abs(got[:, seg] - want[:, seg]).max() \
            <= XLSTM_GRAD_RTOL * scale, path
