"""The port's package rules: it imports neither ``jax`` nor the JAX package
``repro`` nor ``msgpack`` (its checkpoints write the format themselves);
its entry points run on the card unless asked for the CPU and raise where
there is no card; the kernel build raises where there is no ``nvcc``
instead of handing back anything else."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data import FederatedBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.simple import lr_loss  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_scan_covers_every_slice():
    """The scan walks the whole package: each slice's modules are in it,
    the Mamba2, population, paper-twin, buffered-async, fault, MoE,
    xLSTM and launch slices' included (the launch trainer, the dry run and
    its roofline too)."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/flat.py", "kernels/quantize/ops.py",
                "kernels/flash_attention/ops.py", "serving/engine.py",
                "kernels/ssd_scan/ops.py", "kernels/ssd_scan/ref.py",
                "models/mamba2.py", "fed/population.py", "core/theory.py",
                "examples/partial_participation.py", "benchmarks/common.py",
                "benchmarks/run.py", "optim/schedules.py",
                "examples/continuous_batching.py", "fed/clock.py",
                "fed/async_engine.py", "benchmarks/table_async.py",
                "benchmarks/compression_bench.py",
                "examples/buffered_async.py", "fed/keyed.py",
                "fed/scenarios.py", "core/robust.py",
                "benchmarks/scenario_bench.py", "benchmarks/robust_bench.py",
                "checkpoint/serialize.py", "checkpoint/_msgpack.py",
                "data/pipeline.py", "benchmarks/population_bench.py",
                "examples/failure_scenarios.py", "serving/personalized.py",
                "benchmarks/serving_bench.py",
                "examples/personalized_serving.py", "models/moe.py",
                "models/xlstm.py", "examples/serve_batched.py",
                "optim/sgd.py", "optim/adamw.py", "dist.py",
                "configs/shapes.py", "launch/mesh.py", "launch/specs.py",
                "launch/distributed.py", "launch/serve.py",
                "launch/train.py", "launch/dryrun.py",
                "roofline/analysis.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    assert path.is_file()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")]
    assert not bad, f"{path.name} imports {bad}"


def _small_task():
    data, parts = fedprox_synthetic(0, 2, d=4, n_classes=3, n_per_client=8)
    return data, parts


def test_entry_points_without_device_raise_where_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    data, parts = _small_task()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedBatcher(data, parts, batch_size=2)
    batcher = FederatedBatcher(data, parts, batch_size=2, device="cpu")
    fed = FedConfig(algorithm="fedavg", n_clients=2, param_layout="flat")
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedSimulation(lr_loss, params, fed, batcher)
    sim = FederatedSimulation(lr_loss, params, fed, batcher, device="cpu",
                              k_schedule=np.ones((1, 2), np.int32))
    assert sim.state["params"].device.type == "cpu"


# the fields whose features the port has since brought: buffer_size (the
# synchronous engine runs its round whatever it says, as the reference's
# does; the buffered engine is BufferedAsyncSimulation), compression on
# the cohort round (A9), failure scenarios (A8), robust aggregation (A10),
# the mixed-precision master (A3) and the tree layout (A2)
PORTED = {("cohort_size", "A9"), ("buffer_size", "A7"), ("scenario", "A8"),
          ("quarantine_window", "A10"), ("defense", "A10"),
          ("master_dtype", "A3"), ("param_layout", "A2")}


def _reference_round(fed_kw, sim, cohort=None):
    """The reference's round on the port simulation's first round: its
    initial params, batches and K row (and cohort, drawn by the port)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import FedConfig as JFedConfig
    from repro.core import compress as jcompress
    from repro.core import flat as jflat
    from repro.core import robust as jrobust
    from repro.core import rounds as jrounds
    from repro.core.fedopt import get_algorithm as j_get_algorithm
    from repro.fed.scenarios import make_scenario as j_make_scenario
    from repro.models.simple import lr_loss as j_lr_loss
    jfed = JFedConfig(**fed_kw)
    algo = j_get_algorithm(jfed.algorithm, jfed)
    params = {"w": jnp.zeros((4, 3)), "b": jnp.zeros(3)}
    spec = jflat.make_flat_spec(params)
    comp = jcompress.CompressionConfig.from_fed(jfed)
    rb = jrobust.RobustConfig.from_fed(jfed)
    wire = dict(compression=comp, robust=rb, attack=j_make_scenario(jfed))
    state = jrounds.init_state(jflat.ravel(spec, params), 2, algo,
                               compression=comp, spec=spec, robust=rb)
    ks = np.ones(2, np.int32)
    if cohort is None:
        batches = sim.batcher.round_batches(0, 1)
        fn = jflat.make_flat_round(spec, j_lr_loss, algo, lr=jfed.lr,
                                   k_max=1, **wire)
        state, _ = fn(state, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                          batches),
                      jnp.asarray(ks), jnp.asarray(
                          sim.weights.numpy()), jnp.float32(algo.lam))
    else:
        ids, cw = cohort
        batches = sim.batcher.cohort_batches(0, ids, 1)
        fn = jflat.make_flat_cohort_round(spec, j_lr_loss, algo, lr=jfed.lr,
                                          k_max=1, **wire)
        state, _ = fn(state, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                          batches),
                      jnp.asarray(ids), jnp.asarray(ks[ids]),
                      jnp.asarray(cw), jnp.float32(algo.lam))
    return np.asarray(state["params"])


@pytest.mark.parametrize("field,value,item", [
    ("param_layout", "tree", "A2"), ("cohort_size", 1, "A9"),
    ("buffer_size", 1, "A7"), ("scenario", "dropout", "A8"),
    ("quarantine_window", 1, "A10"), ("defense", "median", "A10"),
    ("master_dtype", "float32", "A3")])
def test_unported_config_fields_raise(field, value, item):
    """A field whose feature the port does not run raises, naming its
    ROADMAP item; those it has since brought (``PORTED``) run, and their
    first round matches the reference's."""
    data, parts = _small_task()
    batcher = FederatedBatcher(data, parts, batch_size=2, device="cpu")
    kw = {"param_layout": "flat", field: value}
    if field == "cohort_size":
        # cohorts run, and since A9 compression on the cohort round too
        kw["compressor"] = "int8"
    fed = FedConfig(algorithm="fedavg", n_clients=2, **kw)
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    if (field, item) not in PORTED:
        with pytest.raises(NotImplementedError, match=item):
            FederatedSimulation(lr_loss, params, fed, batcher, device="cpu")
        return
    sim = FederatedSimulation(lr_loss, params, fed, batcher, device="cpu",
                              k_schedule=np.ones((1, 2), np.int32))
    drawn = []
    if sim._partial:
        host_cohort = sim.population.host_cohort

        def recorded(t):
            drawn.append(host_cohort(t))
            return drawn[-1]
        sim.population.host_cohort = recorded
    sim.run(1)
    want = _reference_round(dict(algorithm="fedavg", n_clients=2, **kw),
                            sim, drawn[0] if drawn else None)
    got = sim.state["params"]
    if sim.layout == "tree":
        # the tree round's model in the reference's flat layout
        from repro_torch.core import flat
        assert set(got) == {"w", "b"}
        got = flat.ravel(sim.flat_spec, got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("sampler", ["all", "uniform", "weighted",
                                     "availability", "round_robin"])
def test_cohort_config_constructs_and_runs_a_round(sampler):
    """``cohort_size < n_clients`` runs the cohort round on the CPU with
    each sampler ("all" with C < M resolves to "uniform")."""
    data, parts = _small_task()
    batcher = FederatedBatcher(data, parts, batch_size=2, device="cpu")
    fed = FedConfig(algorithm="fedagrac", n_clients=2, param_layout="flat",
                    cohort_size=1, cohort_sampler=sampler)
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    sim = FederatedSimulation(lr_loss, params, fed, batcher, device="cpu",
                              k_schedule=np.ones((1, 2), np.int32))
    assert sim._partial
    assert sim.population.sampler == ("uniform" if sampler == "all"
                                      else sampler)
    hist = sim.run(1)
    assert len(hist.loss) == len(hist.mass) == 1
    assert np.isfinite(hist.loss[0])
    assert hist.bytes_up == [sim._wire["uplink_per_client"]]
    assert sim.state["nu_i"].shape == (2, sim._spec.p)


def test_config_validates_registry_fields():
    with pytest.raises(ValueError, match="algorithm"):
        FedConfig(algorithm="fedsgd")
    with pytest.raises(ValueError, match="server_opt"):
        FedConfig(server_opt="lamb")


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.library("calibrated_update")
    assert not (tmp_path / "build").exists()


def test_serve_engine_without_device_raises_where_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServeEngine
    cfg = reduced(get_arch("llama3-8b"), n_layers=1, d_model=64, vocab=32)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, slots=1, max_len=16, prefill_buckets=(8,))
    eng = ServeEngine(cfg, params, slots=1, max_len=16, prefill_buckets=(8,),
                      device="cpu")
    assert eng.caches[0]["k"].device.type == "cpu"


def test_init_caches_without_device_raises_where_no_cuda():
    """``init_caches`` resolves ``device=None`` to the card like every
    other entry point, instead of building the caches on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import init_caches
    cfg = reduced(get_arch("llama3-8b"), n_layers=1, d_model=64, vocab=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_caches(cfg, 1, 16)
    caches = init_caches(cfg, 1, 16, device="cpu")
    assert caches[0]["k"].device.type == "cpu"


def test_lm_training_entry_points_without_device_raise_where_no_cuda():
    """The federated LM path's entry points (slice 4): the LM batcher and
    the example default to the card like every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    from repro_torch.data import LMFederatedBatcher, lm_sequences
    from repro_torch.examples import fed_lm_train
    streams = [lm_sequences(i, 2, 4, 16, skew_topic=i) for i in range(2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMFederatedBatcher(streams, batch_size=1)
    assert LMFederatedBatcher(streams, batch_size=1,
                              device="cpu").weights.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fed_lm_train.main(["--small", "--rounds", "1"])
