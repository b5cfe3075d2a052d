"""Federated LM training in the port against the JAX package on the CPU:
the reference's ``tests/test_flat_apply.py::_lm_setup`` (reduced gemma-2b
— 2 layers, d 64, vocab 256, MQA, GeGLU, tied embeddings — 3 clients,
batch 2, K_i = 2, lr 0.1, λ 0.5) run through ``FederatedSimulation`` with
``param_layout="flat"`` in both packages, from the reference's weights and
token streams (numpy arrays carried across).

At SEQ 16 the reference takes its blocked attention (its kernel gate needs
S % 128 == 0); at SEQ 128 with ``REPRO_FLASH_ATTENTION=interpret`` its
gradients go through the Pallas backward kernels in interpret mode.  The
port runs its plain flash-attention forward and backward through
``FlashAttentionFn`` and its vmap rule either way.

Tolerances.  Both sides run the same float32 operations summed in other
orders (XLA against PyTorch; about an ulp per operation).  After two
rounds of two local steps the parameters agree to PARAMS_ATOL absolute
plus PARAMS_RTOL relative (weights up to 0.6, measured ≤ 8.2e-8 apart)
and the round losses to LOSS_RTOL (~5.5 nats, measured ≤ 9e-8 relative).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.data import LMFederatedBatcher as JLMBatcher  # noqa: E402
from repro.data import lm_sequences as jlm_sequences  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.data import LMFederatedBatcher, lm_sequences  # noqa: E402
from repro_torch.data.synthetic import token_probs  # noqa: E402
from repro_torch.examples import fed_lm_train  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M_CLIENTS, BATCH = 3, 2
PARAMS_RTOL, PARAMS_ATOL, LOSS_RTOL = 1e-5, 2e-6, 1e-5
# the hybrid rounds' parameters (test_flat_hybrid_rounds_match_reference)
HYBRID_PARAMS_ATOL = 1e-3


def _setup(seq, arch="gemma-2b", **cut):
    """The reference's ``_lm_setup`` at ``seq``: (jax cfg, port cfg, jax
    streams, jax params); ``arch`` and ``cut`` (``reduced``'s arguments)
    replace its model."""
    cut = cut or {"n_layers": 2, "d_model": 64, "vocab": 256}
    cfg = jreduced(jget_arch(arch), **cut)
    tcfg = reduced(get_arch(arch), **cut)
    key = jax.random.PRNGKey(0)
    streams = [jlm_sequences(jax.random.fold_in(key, i), 16, seq, cfg.vocab,
                             skew_topic=i) for i in range(M_CLIENTS)]
    return cfg, tcfg, streams, JM.init_params(key, cfg)


def _np_streams(streams):
    return [{k: np.asarray(v) for k, v in s.items()} for s in streams]


def _fed(cls, algo):
    return cls(algorithm=algo, n_clients=M_CLIENTS, k_mean=2, lr=0.1,
               calibration_rate=0.5, param_layout="flat")


def _run_both(algo, seq, rounds=2, setup=_setup):
    cfg, tcfg, streams, params = setup(seq)
    jloss = functools.partial(JM.lm_loss, cfg=cfg)
    jsim = JSimulation(lambda p, b: jloss(p, b), params, _fed(JFedConfig, algo),
                       JLMBatcher(streams, batch_size=BATCH), t_max=rounds)
    jhist = jsim.run(rounds, eval_every=rounds)
    tloss = functools.partial(TM.lm_loss, cfg=tcfg)
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tsim = FederatedSimulation(
        lambda p, b: tloss(p, b), tparams, _fed(FedConfig, algo),
        LMFederatedBatcher(_np_streams(streams), batch_size=BATCH,
                           device="cpu"),
        t_max=rounds, device="cpu")
    before = dict(fa_ops.launches)
    thist = tsim.run(rounds, eval_every=rounds)
    assert fa_ops.launches == before          # CPU tensors launch nothing
    return jsim, jhist, tsim, thist


def _assert_close(jsim, jhist, tsim, thist, params_atol=PARAMS_ATOL):
    np.testing.assert_allclose(thist.loss, jhist.loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(thist.kbar, jhist.kbar, rtol=1e-7)
    np.testing.assert_allclose(tsim.state["params"].numpy(),
                               np.asarray(jsim.state["params"]),
                               rtol=PARAMS_RTOL, atol=params_atol)
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jsim.params))
    got = [t.numpy() for _, t in flat._leaves(tsim.params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=PARAMS_RTOL, atol=params_atol)


def test_lm_batcher_is_bit_identical():
    _, _, streams, _ = _setup(16)
    jb = JLMBatcher(streams, batch_size=BATCH, seed=3)
    tb = LMFederatedBatcher(_np_streams(streams), batch_size=BATCH, seed=3,
                            device="cpu")
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    for t in range(3):
        want = jb.round_batches(t, 4)
        got = tb.round_batches(t, 4)
        for key in ("tokens", "labels"):
            assert got[key].shape == (M_CLIENTS, 4, BATCH, 16)
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    chunk = tb.chunk_batches(1, 2, 4)
    for j in range(2):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(
                chunk[key][j].numpy(), np.asarray(jb.round_batches(1 + j, 4)
                                                  [key]))


@pytest.mark.parametrize("algo", ["fedagrac", "fedavg", "fednova"])
def test_flat_lm_rounds_match_reference(algo):
    """Two flat rounds at SEQ 16 (the reference's blocked attention)."""
    _assert_close(*_run_both(algo, 16))


def test_flat_lm_round_through_pallas_backward(monkeypatch):
    """One fedagrac round at SEQ 128, the reference's gradients through its
    Pallas forward and backward kernels in interpret mode."""
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "interpret")
    _assert_close(*_run_both("fedagrac", 128, rounds=1))


# this test needs the module's one intra-op thread (``_one_cpu_thread``):
# with several, the reduced hybrid's embedding gradient differs by an ulp
# between identical calls on the CPU (ROADMAP C18), and the rounds amplify
# it
@pytest.mark.parametrize("algo", ["fedagrac", "fedavg"])
def test_flat_hybrid_rounds_match_reference(algo):
    """Two flat rounds of zamba2's hybrid stack — ``reduced(zamba2-2.7b,
    n_layers=4)``: d 128, 8 SSM heads of dim 32, d_state 16, chunk 16, a
    shared attention block after every 2 Mamba2 layers (two groups) — at
    SEQ 32, so every SSD call runs two chunks: the reference
    differentiates its ``ssd_chunked`` by autodiff, the port through
    ``SSDScanFn``'s explicit chunked VJP, folded over the three clients.
    LOSS_RTOL holds (measured 3.8e-7).  The parameters are held to
    HYBRID_PARAMS_ATOL (measured 3.4e-4 for fedagrac, 2.1e-4 for fedavg,
    the embedding's, on weights up to 2.08): at the same weights the
    hybrid's gradients agree with the reference's to 1.1e-5 of the largest
    entry (the embedding's, against ~1e-7 for gemma's) and the rounds
    amplify it — the port's earlier CPU route, autograd of the plain
    forward, ends as far from the reference (2.2e-4 / 1.5e-4), and
    reversing each client's batch rows in the port alone moves the
    weights by 1.0e-5 (gemma's: 6e-8)."""
    dist.unset_mesh()
    _assert_close(*_run_both(algo, 32, setup=functools.partial(
        _setup, arch="zamba2-2.7b", n_layers=4)),
        params_atol=HYBRID_PARAMS_ATOL)


def test_token_streams_follow_the_reference_law():
    """The same Zipf + topic-band law as the reference (which draws with
    ``jax.random``, so only the law can agree), and a seed fixes the
    stream."""
    probs = token_probs(256, skew_topic=2)
    ranks = np.arange(1, 257, dtype=np.float64) ** -1.2
    boost = np.zeros(256)
    boost[64:96] = 1.0
    want = ranks * (1 + 7 * boost)
    np.testing.assert_allclose(probs, want / want.sum(), rtol=1e-12)
    a = lm_sequences(5, 4, 9, 256, skew_topic=2)
    b = lm_sequences(5, 4, 9, 256, skew_topic=2)
    assert a["tokens"].shape == (4, 9) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    big = lm_sequences(0, 256, 32, 256, skew_topic=2)["tokens"].numpy()
    freq = np.bincount(big.ravel(), minlength=256) / big.size
    assert np.abs(freq - probs).max() < 0.01


def test_small_example_learns_on_cpu(capsys, tmp_path):
    final = fed_lm_train.main(["--small", "--device", "cpu", "--rounds", "2",
                               "--eval-every", "1", "--ckpt",
                               str(tmp_path / "fed_lm_{round}.msgpack")])
    out = capsys.readouterr().out
    ppl = [float(line.split("held-out ppl")[1].split()[0])
           for line in out.splitlines() if "held-out ppl" in line]
    assert len(ppl) == 2 and ppl[1] < ppl[0] < 256
    assert final == pytest.approx(ppl[1], abs=0.05) and final < 0.8 * 256


@pytest.mark.parametrize("argv,item", [
    (["--bf16"], "A3"), (["--sampler", "device"], "A5"),
    (["--layout", "tree"], "A2"), (["--ckpt", "x.msgpack"], "A11")])
def test_example_refuses_unported_flags(argv, item, tmp_path):
    """The flags these cases once refused run: the device sampler (A5),
    checkpoints (A11), ``--bf16`` (A3: bfloat16 leaves over a float32
    master) and ``--layout tree`` (A2, whose round matches the flat
    layout's on the same example within PARAMS_RTOL / PARAMS_ATOL); the
    model saved at each eval boundary restores into the simulation's
    parameter tree."""
    fmt = str(tmp_path / "fed_lm_{round}.msgpack")
    if item == "A11":
        argv = ["--ckpt", fmt]
    sims = []
    real = fed_lm_train.make_simulation

    def kept(*args, **kw):
        sims.append(real(*args, **kw))
        return sims[-1]
    fed_lm_train.make_simulation = kept
    try:
        if item == "A2":
            fed_lm_train.main(["--small", "--device", "cpu", "--rounds",
                               "1", "--eval-every", "1", "--ckpt", "",
                               "--layout", "flat"])
        fed_lm_train.main(["--small", "--device", "cpu", "--rounds", "1",
                           "--eval-every", "1", "--ckpt", fmt, *argv])
    finally:
        fed_lm_train.make_simulation = real
    sim = sims[-1]
    assert sim._device_sampler == (item == "A5")
    master = (sim.state["params"] if item != "A2"
              else flat.ravel(sim.flat_spec, sim.state["params"]))
    assert master.dtype == torch.float32
    leaves = torch.utils._pytree.tree_leaves(sim.params)
    leaf_dtypes = {t.dtype for t in leaves}
    assert leaf_dtypes == {torch.bfloat16 if item == "A3"
                           else torch.float32}
    if item == "A2":
        assert sim.layout == "tree" and sims[0].layout == "flat"
        got, want = (dict(flat._leaves(s.params)) for s in (sim, sims[0]))
        assert set(got) == set(want)
        for path, a in got.items():
            np.testing.assert_allclose(a.numpy(), want[path].numpy(),
                                       rtol=PARAMS_RTOL, atol=PARAMS_ATOL,
                                       err_msg=str(path))
    from repro_torch.checkpoint import serialize
    restored = serialize.load(fmt.format(round=1), sim.params)
    for a, b in zip(torch.utils._pytree.tree_leaves(restored), leaves):
        assert torch.equal(a, b)
