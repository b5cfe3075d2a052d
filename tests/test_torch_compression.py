"""The port's wire-compression stage (``repro_torch.core.compress``) against
the JAX package's: every codec on the same rows, the bytes model, the
config checks, the compressed flat round over three rounds, a compressed
JAX state resumed in the port, and ``History``'s byte series.

Tolerances.  A codec given equal inputs gives equal outputs: the codecs
compare exactly.  The round's float32 arithmetic agrees with the
reference's only to about an ulp per local step (tests/test_torch_round.py),
and a codec is discontinuous: an ulp can move x/s across a .5 tie (one
int8/int4 code changes by one step s = amax/qmax) or reorder two magnitudes
at the top-k threshold (one slot changes by up to the threshold t, plus s
for topk+int8).  So each round is fed the SAME input state in both packages
(the JAX state carried across with ``convert.flat_state_from_numpy``), and
a compressed quantity (params, ν, ``ef_up``, ``ef_nu``) is held to the
float32 tolerance of tests/test_torch_round.py except in at most one
element per client row and round (M elements of a ``(P,)`` vector), each
within one step of its row's codec more.  Such flips do occur: in the
reference's jitted round XLA can round a top-k operand differently where
it takes the threshold and where it masks, so a row's k-th slot drops out
there (one slot in each of three rows, in one of these rounds), where the
port keeps it.
``nu_i`` passes through no codec and keeps the plain tolerance.  The
broadcast codec sees equal inputs in both packages, so its codes are the
same; its residuals ``ef_down``/``ef_down_nu`` = x − q·s still differ by a
rounding, because XLA contracts the product and the difference into one
FMA, and they keep the plain tolerance too.
"""
import pytest

torch = pytest.importorskip("torch")

import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.core import rounds as jrounds  # noqa: E402
from repro.core.fedopt import get_algorithm as j_get_algorithm  # noqa: E402
from repro.data import FederatedBatcher as JBatcher  # noqa: E402
from repro.data import fedprox_synthetic as j_synthetic  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.fed.simulation import History as JHistory  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.models.simple import lr_accuracy as j_lr_accuracy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import compress, flat, rounds  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.data import FederatedBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.fed import FederatedSimulation, History  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

M, B, D, C, HIDDEN = 4, 6, 8, 4, 16
LR, LAM = 0.05, 0.5
NAMES = sorted(compress.COMPRESSORS)
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)
NU_TOL = dict(rtol=1e-5, atol=1e-5)
MODELS = {"lr": (jsimple.lr_loss, simple.lr_loss,
                 {"w": (D, C), "b": (C,)}),
          "mlp": (jsimple.mlp_loss, simple.mlp_loss,
                  {"w1": (D, HIDDEN), "b1": (HIDDEN,), "w2": (HIDDEN, C),
                   "b2": (C,)})}


# ---------------------------------------------------------------------------
# codecs and the bytes model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,n,p", [(1, 610, 640), (10, 610, 640),
                                      (3, 100, 128)])
@pytest.mark.parametrize("name", NAMES)
def test_codec_matches_reference(name, rows, n, p, dtype):
    """The same rows (a poisoned pad tail, an all-zero row) through both
    packages' codecs: exactly equal, and zero in the pad."""
    rng = np.random.default_rng(7)
    x = (2.0 * rng.standard_normal((rows, p))).astype(np.float32)
    x[:, n:] = 1e9
    x[-1, :] = 0.0
    want = jcompress.make_codec(name, n, use_pallas=True, interpret=True)(
        jnp.asarray(x).astype(dtype))
    got = compress.make_codec(name, n)(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (rows, p)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if name != "none":
        assert not got[:, n:].any()


@pytest.mark.parametrize("n", [1, 610, 4554])
@pytest.mark.parametrize("name", NAMES)
def test_bytes_model_matches_reference(name, n):
    assert compress.payload_bytes(name, n) == jcompress.payload_bytes(name, n)
    for frac in (0.05, 0.5, 1.0):
        assert (compress.payload_bytes(name, n, topk_frac=frac)
                == jcompress.payload_bytes(name, n, topk_frac=frac))
    for uses_nu in (False, True):
        for down in ("none", name):
            cfg = compress.CompressionConfig(uplink=name, downlink=down)
            jcfg = jcompress.CompressionConfig(uplink=name, downlink=down)
            assert (compress.wire_cost(n, uses_nu, cfg)
                    == jcompress.wire_cost(n, uses_nu, jcfg))
        assert (compress.wire_cost(n, uses_nu, None)
                == jcompress.wire_cost(n, uses_nu, None))


def test_topk_k_rounds_half_to_even():
    """n = 610 at 5 % is 30.5 slots: Python's round gives 30, as the
    reference's does (floor(x + ½) would give 31)."""
    assert compress._topk_k(610, 0.05) == jcompress._topk_k(610, 0.05) == 30
    assert compress.payload_bytes("topk", 610) == 8.0 * 30


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"compressor": "int2"}, "compressor"),
    ({"broadcast_compressor": "fp8"}, "broadcast_compressor"),
    ({"topk_frac": 0.0}, "topk_frac"),
    ({"topk_frac": 1.5}, "topk_frac")])
def test_config_rejects_bad_compression_fields(kw, match):
    with pytest.raises(ValueError, match=match):
        FedConfig(**kw)
    with pytest.raises(ValueError, match=match):
        JFedConfig(**kw)


@pytest.mark.parametrize("compressor", ["none", "topk"])
def test_quantize_transmit_folds_into_int8(compressor):
    with pytest.warns(DeprecationWarning, match="quantize_transmit"):
        fed = FedConfig(quantize_transmit=True, compressor=compressor)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jfed = JFedConfig(quantize_transmit=True, compressor=compressor)
    assert fed.compressor == jfed.compressor
    assert fed.compressor == ("int8" if compressor == "none" else "topk")


@pytest.mark.parametrize("up,down,ef", [("none", "none", True),
                                        ("topk+int8", "none", False),
                                        ("none", "int4", True)])
def test_compression_config_from_fed_matches_reference(up, down, ef):
    kw = dict(compressor=up, broadcast_compressor=down, error_feedback=ef,
              topk_frac=0.1)
    got = compress.CompressionConfig.from_fed(FedConfig(**kw))
    want = jcompress.CompressionConfig.from_fed(JFedConfig(**kw))
    if want is None:
        assert got is None
    else:
        assert (got.uplink, got.downlink, got.error_feedback,
                got.topk_frac, got.active) == (
            want.uplink, want.downlink, want.error_feedback, want.topk_frac,
            want.active)


# ---------------------------------------------------------------------------
# the compressed flat round
# ---------------------------------------------------------------------------

def _inputs(model, seed, n_rounds):
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


def _configs(algorithm, up, down, ef):
    kw = dict(algorithm=algorithm, n_clients=M, lr=LR, calibration_rate=LAM,
              param_layout="flat", compressor=up, broadcast_compressor=down,
              error_feedback=ef, topk_frac=0.1)
    return JFedConfig(**kw), FedConfig(**kw)


def _jax_run(model, jfed, params, k_steps, weights, batches):
    """The reference's states after each round (numpy), from init."""
    algo = j_get_algorithm(jfed.algorithm, jfed)
    spec = jflat.make_flat_spec(jax.tree.map(jnp.asarray, params))
    comp = jcompress.CompressionConfig.from_fed(jfed)
    fn = jax.jit(jflat.make_flat_round(spec, MODELS[model][0], algo, lr=LR,
                                       k_max=5, compression=comp))
    state = jrounds.init_state(jflat.ravel(spec, jax.tree.map(jnp.asarray,
                                                              params)),
                               M, algo, compression=comp, spec=spec)
    states = [jax.tree.map(np.asarray, state)]
    for b in batches:
        state, _ = fn(state, jax.tree.map(jnp.asarray, b),
                      jnp.asarray(k_steps), jnp.asarray(weights),
                      jnp.float32(LAM))
        states.append(jax.tree.map(np.asarray, state))
    return states


def _port_round(model, fed, params):
    algo = get_algorithm(fed.algorithm, fed)
    tparams = convert.params_from_numpy(params, "cpu")
    spec = flat.make_flat_spec(tparams)
    comp = compress.CompressionConfig.from_fed(fed)
    fn = flat.make_flat_round(spec, MODELS[model][1], algo, lr=LR, k_max=5,
                              compression=comp)
    return spec, algo, comp, fn


@pytest.fixture
def codec_inputs(monkeypatch):
    """Records what each uplink stage hands its codec, by state key."""
    seen = {}
    real = compress.make_rows_stage

    def spying_rows_stage(codec, error_feedback, key):
        def spy(mat):
            seen[key] = mat.detach().clone()
            return codec(mat)
        return real(spy, error_feedback, key)

    monkeypatch.setattr(compress, "make_rows_stage", spying_rows_stage)
    return seen


def _codec_steps(name, target, n, topk_frac):
    """(rows, 1): the most one flip of codec ``name`` can move an element
    of a row — s = amax/qmax for int8/int4, the threshold t for top-k,
    t + amax/127 for topk+int8."""
    t = target.float()
    if name in ("int8", "int4"):
        return qops.row_scales(t, n, compress._QMAX[name]).numpy()
    th = qops.topk_thresholds(t, n, compress._topk_k(n, topk_frac)).numpy()
    if name == "topk":
        return th
    return th + qops.masked_abs_rowmax(t, n).numpy() / 127


def _assert_close_but_flips(got, want, tol, step, what):
    got = got.float().numpy()
    err = np.abs(got - want)
    lim = tol["atol"] + tol["rtol"] * np.abs(want)
    beyond = err > lim
    flips = beyond.sum(axis=-1)              # per client row, or in all
    assert (flips <= (1 if beyond.ndim == 2 else M)).all(), (
        f"{what}: {flips} elements beyond float32 tolerance "
        f"(max |err| {err.max()})")
    bound = lim + np.broadcast_to(step, err.shape) * (1 + 1e-5)
    assert (err <= bound).all(), f"{what}: max |err| {err.max()}"


def _assert_round_matches(got, want, fed, spec, seen):
    assert set(got) == set(want)
    assert int(got["round"]) == int(want["round"])
    n = spec.n
    up_steps = {key: _codec_steps(fed.compressor, seen[key], n,
                                  fed.topk_frac)
                for key in ("ef_up", "ef_nu") if key in seen}
    zero = np.zeros((1, 1), np.float32)
    delta_step = up_steps.get("ef_up", zero)
    nu_step = up_steps.get("ef_nu", zero)
    _assert_close_but_flips(got["params"], want["params"], PARAMS_TOL,
                            delta_step.max(), "params")
    if "nu" in want:
        _assert_close_but_flips(got["nu"], want["nu"], NU_TOL,
                                nu_step.max(), "nu")
        np.testing.assert_allclose(got["nu_i"].numpy(), want["nu_i"],
                                   **NU_TOL)
    if "ef_up" in want:
        _assert_close_but_flips(got["ef_up"], want["ef_up"], PARAMS_TOL,
                                delta_step, "ef_up")
    if "ef_nu" in want:
        _assert_close_but_flips(got["ef_nu"], want["ef_nu"], NU_TOL,
                                nu_step, "ef_nu")
    for key, tol in (("ef_down", PARAMS_TOL), ("ef_down_nu", NU_TOL)):
        if key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key], **tol)
    assert not got["params"][n:].any()


ROUND_CASES = [
    (algorithm, up, down, ef)
    for algorithm, up_only, (up, down) in [
        ("fedagrac", "topk+int8", ("topk+int8", "int8")),
        ("fedavg", "int4", ("topk", "int4")),
        ("fednova", "topk", ("int8", "topk")),
        ("fedprox", "int8", ("int4", "topk+int8"))]
    for up, down in [(up_only, "none"), (up, down)]
    for ef in (True, False)]


@pytest.mark.parametrize("algorithm,up,down,ef", ROUND_CASES)
def test_compressed_round_matches_jax(codec_inputs, algorithm, up, down, ef):
    """Three rounds; each starts both packages from the reference's state
    of the round before (carried across with ``convert``)."""
    params, k_steps, weights, batches = _inputs("lr", 21, 3)
    jfed, fed = _configs(algorithm, up, down, ef)
    want = _jax_run("lr", jfed, params, k_steps, weights, batches)
    spec, algo, comp, fn = _port_round("lr", fed, params)
    init = rounds.init_state(
        flat.ravel(spec, convert.params_from_numpy(params, "cpu")), M, algo,
        compression=comp, spec=spec)
    assert set(init) == set(want[0])
    for key in init:
        np.testing.assert_array_equal(init[key].numpy(), want[0][key])
    for r, b in enumerate(batches):
        codec_inputs.clear()
        state = convert.flat_state_from_numpy(want[r], "cpu")
        got, _ = fn(state, convert.params_from_numpy(b, "cpu"),
                    torch.from_numpy(k_steps), torch.from_numpy(weights), LAM)
        _assert_round_matches(got, want[r + 1], fed, spec, codec_inputs)


def test_compressed_state_carried_from_jax_resumes(codec_inputs):
    """Two compressed rounds in JAX (all four EF accumulators in the
    state), carried into the port, round 3 in both packages."""
    params, k_steps, weights, batches = _inputs("mlp", 22, 3)
    jfed, fed = _configs("fedagrac", "topk+int8", "int8", True)
    want = _jax_run("mlp", jfed, params, k_steps, weights, batches)
    carried = convert.flat_state_from_numpy(want[2], "cpu")
    assert set(compress.EF_KEYS) <= set(carried)
    assert carried["ef_up"].shape == (M, want[2]["params"].shape[0])
    spec, _, _, fn = _port_round("mlp", fed, params)
    got, _ = fn(carried, convert.params_from_numpy(batches[2], "cpu"),
                torch.from_numpy(k_steps), torch.from_numpy(weights), LAM)
    _assert_round_matches(got, want[3], fed, spec, codec_inputs)


@pytest.mark.parametrize("algorithm", ["fedagrac", "fedavg"])
def test_none_compression_runs_the_unchanged_round(algorithm):
    """An all-"none" config builds the round of ``compression=None``: the
    same state keys and the same bits."""
    params, k_steps, weights, batches = _inputs("lr", 23, 2)
    _, fed = _configs(algorithm, "none", "none", True)
    assert compress.CompressionConfig.from_fed(fed) is None
    tparams = convert.params_from_numpy(params, "cpu")
    spec = flat.make_flat_spec(tparams)
    algo = get_algorithm(algorithm, fed)
    finals = []
    for comp in (None, compress.CompressionConfig()):
        fn = flat.make_flat_round(spec, simple.lr_loss, algo, lr=LR, k_max=5,
                                  compression=comp)
        state = rounds.init_state(flat.ravel(spec, tparams), M, algo,
                                  compression=comp, spec=spec)
        for b in batches:
            state, _ = fn(state, convert.params_from_numpy(b, "cpu"),
                          torch.from_numpy(k_steps),
                          torch.from_numpy(weights), LAM)
        finals.append(state)
    assert set(finals[0]) == set(finals[1])
    assert not set(compress.EF_KEYS) & set(finals[0])
    for key in finals[0]:
        assert torch.equal(finals[0][key], finals[1][key]), key


# ---------------------------------------------------------------------------
# the simulation: History's byte series
# ---------------------------------------------------------------------------

N_SIM, T_SIM = 10, 3


@pytest.fixture(scope="module")
def lr_task():
    key = jax.random.PRNGKey(0)
    jdata, jparts = j_synthetic(key, N_SIM, alpha=1.0, beta=1.0)
    data, parts = fedprox_synthetic(
        int(jax.random.randint(key, (), 0, 2 ** 31 - 1)), N_SIM, alpha=1.0,
        beta=1.0)
    return jdata, jparts, data, parts


@pytest.mark.parametrize("algorithm,up,down", [
    ("fedagrac", "topk+int8", "none"), ("fedavg", "int4", "int8"),
    ("fedagrac", "none", "none")])
def test_history_bytes_match_reference(lr_task, algorithm, up, down):
    """The compression bench's sync workload (lr on FedProx
    synthetic(1,1), the bimodal schedule) for three rounds: both packages
    record the same byte series, and ``bytes_to_target`` spends it the
    same way."""
    jdata, jparts, data, parts = lr_task
    ks = np.full((1, N_SIM), 2, np.int32)
    ks[0, -1] = 20
    kw = dict(algorithm=algorithm, n_clients=N_SIM, lr=0.02,
              calibration_rate=1.0, weights="data", param_layout="flat",
              compressor=up, broadcast_compressor=down)
    jsim = JSimulation(
        jsimple.lr_loss, {"w": jnp.zeros((60, 10)), "b": jnp.zeros((10,))},
        JFedConfig(**kw), JBatcher(jdata, jparts, batch_size=20),
        eval_fn=lambda p: float(j_lr_accuracy(p, {"x": jdata.x,
                                                  "y": jdata.y})),
        k_schedule=ks)
    sim = FederatedSimulation(
        simple.lr_loss, {"w": torch.zeros(60, 10), "b": torch.zeros(10)},
        FedConfig(**kw),
        FederatedBatcher(data, parts, batch_size=20, device="cpu"),
        eval_fn=lambda p: float(simple.lr_accuracy(p, {"x": data.x,
                                                       "y": data.y})),
        k_schedule=ks, device="cpu")
    want = jsim.run(T_SIM)
    got = sim.run(T_SIM)
    assert got.bytes_up == want.bytes_up and len(got.bytes_up) == T_SIM
    assert got.bytes_down == want.bytes_down
    wire = compress.wire_cost(sim._spec.n, sim.algo.uses_nu,
                              sim.compression)
    assert got.bytes_up[0] == N_SIM * wire["uplink_per_client"]
    assert got.bytes_down[0] == N_SIM * wire["downlink_per_client"]
    assert np.isfinite(got.loss).all()
    # the round's first loss is taken before any codec runs on a
    # trajectory of its own: it is the plain float32 comparison
    np.testing.assert_allclose(got.loss[0], want.loss[0], rtol=1e-5)
    for target in (0.0, 2.0):               # reached at once; never
        assert got.bytes_to_target(target) == want.bytes_to_target(target)


@pytest.mark.parametrize("target", [0.5, 0.6, 0.7, 0.9])
@pytest.mark.parametrize("per_eval", [1, 2])
def test_bytes_to_target_matches_reference(target, per_eval):
    metric = [0.4, 0.55, 0.65, 0.72, 0.71]
    bytes_up = [100.0 + 10 * t for t in range(per_eval * len(metric))]
    got = History(metric=list(metric), bytes_up=list(bytes_up))
    want = JHistory(metric=list(metric), bytes_up=list(bytes_up))
    assert got.bytes_to_target(target) == want.bytes_to_target(target)
    assert (got.bytes_to_target(1 - target, higher_is_better=False)
            == want.bytes_to_target(1 - target, higher_is_better=False))
