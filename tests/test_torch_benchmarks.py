"""The port's paper-experiment twins (``repro_torch.benchmarks``) against
the reference's ``benchmarks/`` on the CPU.

* ``make_task`` / ``make_task_dp2``: the same data, partitions, client
  weights, round indices and initial weights as the reference's, bit for
  bit (numpy draws from the same integers; the mlp from the committed
  ``mlp_init_key0.npz``, equal to ``mlp_init(PRNGKey(0), 60, 64, 10)``).
* ``run_sim`` against the reference's ``run_sim`` (the tree round) for lr
  and mlp, fedagrac and fedprox: losses within the flat-vs-tree tolerance
  of tests/test_torch_round.py (rtol 1e-5, atol 2e-6), accuracies to the
  sample; ``eval_per_client`` / ``History.fairness`` likewise.
* Table 1's ``lr, non_iid`` quick row crosses 0.78 at round 24 in the port
  as in the reference: it sits at 0.78000003 there, one ulp above the
  0.77999997 that ``sum / n`` gave.
* The ``ablation_int8_nu`` twin's quick rows (tree layout, int8 wire)
  equal the reference's.
* ``run.parse_only`` on the cases of tests/test_benchmarks_cli.py; every
  twin's ``main(quick=True)`` on the CPU with its rounds cut to 2 (the
  buffered-async, compression, scenario and robust twins' included), its
  rows lined up with the reference's quick rows; a failing module makes
  ``run`` exit non-zero.  (The scenario and robust twins' full quick rows
  are tests/test_torch_scenario_twin.py and test_torch_robust_twin.py's.)
* ``reference_quick.json``'s thm1, table1 and server_opt rows regenerated
  from the JAX modules, equal to the committed file.
* The engine twin's rows include the tree-vs-flat layout rows.
* The ``continuous_batching`` twin on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import _reference_quick  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.fed.simulation import FederatedSimulation as JSim  # noqa: E402
from repro.models.simple import lr_accuracy as jlr_accuracy  # noqa: E402
from repro.models.simple import mlp_init as jmlp_init  # noqa: E402
from repro_torch.benchmarks import ablation_int8_nu, common  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.benchmarks import table1_deterioration  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.examples import continuous_batching  # noqa: E402
from repro_torch.fed import FederatedSimulation  # noqa: E402
from repro_torch.models.simple import lr_accuracy  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=2e-6)
REFERENCE = json.loads((ROOT / "src" / "repro_torch" / "benchmarks"
                        / "reference_quick.json").read_text())
TWIN_ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The twins run thousands of tiny rounds: one intra-op thread each
    keeps them from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TASKS = {"lr_noniid": (dict(kind="lr", noniid=True), "make_task"),
         "lr_iid": (dict(kind="lr", noniid=False), "make_task"),
         "mlp_noniid": (dict(kind="mlp", noniid=True), "make_task"),
         "fig3_batcher": (dict(kind="lr", noniid=True, batch=5,
                               batcher_seed=2), "make_task"),
         "dp2_mlp": (dict(kind="mlp"), "make_task_dp2")}


def _tasks(case):
    kw, builder = TASKS[case]
    return (getattr(jcommon, builder)(**kw),
            getattr(common, builder)(**kw, device="cpu"))


@pytest.mark.parametrize("case", TASKS)
def test_make_task_matches_reference(case):
    jt, tt = _tasks(case)
    jb, tb = jt.batcher, tt.batcher
    np.testing.assert_array_equal(tb.data.x.numpy(), np.asarray(jb.data.x))
    np.testing.assert_array_equal(tb.data.y.numpy(), np.asarray(jb.data.y))
    assert len(tb.parts) == len(jb.parts) == common.M_CLIENTS
    for tp, jp in zip(tb.parts, jb.parts):
        np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    for t, k in ((0, 20), (1, 200), (7, 3)):
        np.testing.assert_array_equal(tb.round_indices(t, k),
                                      jb.round_indices(t, k))
    assert set(tt.params) == set(jt.params)
    for name, leaf in tt.params.items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(jt.params[name]))
    assert (tt.name, tt.lr) == (jt.name, jt.lr)
    assert tt.eval_fn(tt.params) == jt.eval_fn(jt.params)


def test_committed_mlp_init_is_the_reference_key0_init():
    want = jmlp_init(jax.random.PRNGKey(0), common.D, 64, common.N_CLASSES)
    with np.load(common.MLP_INIT_KEY0) as f:
        assert set(f.files) == set(want)
        for name in f.files:
            assert f[name].dtype == np.float32
            np.testing.assert_array_equal(f[name], np.asarray(want[name]))
    assert sum(np.asarray(v).size for v in want.values()) == 4554


def test_make_task_refuses_unknown_seeds_and_the_device_sampler():
    """Other data seeds need their numpy seed; only seed 0's mlp weights
    are carried across; the device sampler builds a ``DeviceBatcher``
    (its runs: tests/test_torch_device_mode.py)."""
    with pytest.raises(ValueError, match="pass data_seed"):
        common.make_task("lr", noniid=True, seed=1, device="cpu")
    task = common.make_task("lr", noniid=True, seed=1, data_seed=5,
                            device="cpu")
    assert task.batcher.seed == 1
    with pytest.raises(ValueError, match="only seed 0's"):
        common.make_task("mlp", noniid=True, seed=1, data_seed=5,
                         device="cpu")
    from repro_torch.data import DeviceBatcher
    task = common.make_task("lr", noniid=True, sampler="device",
                            device="cpu")
    assert isinstance(task.batcher, DeviceBatcher)
    assert task.batcher.seed == 0


@pytest.mark.parametrize("kind,algo", [("lr", "fedagrac"), ("lr", "fedprox"),
                                       ("mlp", "fedagrac"),
                                       ("mlp", "fedprox")])
def test_run_sim_matches_reference(kind, algo):
    ks = common.bimodal_schedule(k_slow=2, k_fast=8)
    jh = jcommon.run_sim(jcommon.make_task(kind, noniid=True), algo, 4,
                         k_schedule=ks, lam=0.5)
    th = common.run_sim(common.make_task(kind, noniid=True, device="cpu"),
                        algo, 4, k_schedule=ks, lam=0.5)
    assert len(th.loss) == len(th.metric) == 4
    np.testing.assert_allclose(th.loss, jh.loss, **LOSS_TOL)
    np.testing.assert_array_equal(th.metric, jh.metric)


def _per_client_fns(jtask, ttask):
    jdata, tdata = jtask.batcher.data, ttask.batcher.data
    jparts = [{"x": jdata.x[p], "y": jdata.y[p]} for p in jtask.batcher.parts]
    tparts = [{"x": tdata.x[torch.from_numpy(p)],
               "y": tdata.y[torch.from_numpy(p)]}
              for p in ttask.batcher.parts]
    return (lambda p: [float(jlr_accuracy(p, b)) for b in jparts],
            lambda p: [float(lr_accuracy(p, b)) for b in tparts])


def test_eval_per_client_and_fairness_match_reference():
    """The fairness twin's hook: per-client accuracies at each eval
    boundary, ``fairness()`` of the last one; with no ``eval_fn`` the hook
    alone still clamps a longer chunk to the eval cadence."""
    jtask, ttask = _tasks("lr_noniid")
    jfn, tfn = _per_client_fns(jtask, ttask)
    ks = common.bimodal_schedule(k_slow=2, k_fast=8)
    kw = dict(algorithm="fedagrac", n_clients=common.M_CLIENTS,
              lr=common.LR_CONVEX, calibration_rate=1.0, weights="data")
    jsim = JSim(jtask.loss_fn, jtask.params, JFedConfig(**kw),
                jtask.batcher, eval_per_client=jfn, k_schedule=ks)
    tsim = FederatedSimulation(ttask.loss_fn, ttask.params,
                               FedConfig(**kw, param_layout="flat"),
                               ttask.batcher, eval_per_client=tfn,
                               k_schedule=ks, device="cpu")
    with pytest.warns(UserWarning, match="clamped"):
        jh = jsim.run(6, eval_every=3, chunk_rounds=5)
    with pytest.warns(UserWarning, match="clamped"):
        th = tsim.run(6, eval_every=3, chunk_rounds=5)
    assert th.metric == [] and len(th.loss) == 6
    assert len(th.per_client) == len(jh.per_client) == 2
    assert th.per_client == jh.per_client
    assert th.fairness() == jh.fairness()
    assert set(th.fairness()) == {"worst", "best", "std"}
    assert FederatedSimulation(
        ttask.loss_fn, ttask.params, FedConfig(**kw, param_layout="flat"),
        ttask.batcher, k_schedule=ks, device="cpu").run(1).fairness() is None


def test_table1_lr_non_iid_quick_row_crosses_at_round_24():
    task = common.make_task("lr", noniid=True, device="cpu")
    hist = common.run_sim(task, "fedavg", table1_deterioration.T_QUICK,
                          k_mean=20, k_var=0.0)
    assert common.rounds_to(hist, table1_deterioration.TARGET["lr"]) == 24
    assert np.float32(hist.metric[23]) == np.float32(0.78000003)
    row = ["table1", "lr", "non_iid", "24", str(round(hist.metric[-1], 4))]
    assert row in REFERENCE["modules"]["table1"]["rows"]


def test_int8_nu_twin_quick_rows_equal_the_reference():
    """The ``ablation_int8_nu`` twin runs the tree layout with
    ``compressor="int8"``, as the reference's module does: its quick rows
    are the reference's (``reference_quick.json``)."""
    rows = [[str(v) for v in row]
            for row in ablation_int8_nu.run(quick=True, device="cpu")]
    assert rows == REFERENCE["modules"]["int8_nu"]["rows"]


@pytest.mark.parametrize("only,want", [
    (None, list(trun.MODULES)),
    ("engine,thm1,engine", ["engine", "thm1"]),
    (" engine , fairness ", ["engine", "fairness"]),
    ("table_async,compression_bench", ["table_async", "compression"]),
    ("engine,typo_bench", "typo_bench"),
    (" , ,", "selects nothing"),
])
def test_parse_only(only, want):
    """The reference CLI's contract (tests/test_benchmarks_cli.py):
    order-preserving dedup, whitespace tolerated, and a fail-fast error
    naming every valid module for an unknown or empty selection."""
    if isinstance(want, list):
        assert trun.parse_only(only) == want
        return
    with pytest.raises(SystemExit) as e:
        trun.parse_only(only)
    msg = str(e.value)
    assert want in msg
    if want != "selects nothing":
        for name in trun.MODULES:
            assert name in msg


def test_run_exits_non_zero_when_a_module_fails(monkeypatch, capsys):
    def broken(quick=False, device=None):
        raise RuntimeError("broken twin")

    monkeypatch.setattr(trun.MODULES["fig4"], "main", broken)
    with pytest.raises(SystemExit, match=r"benchmark failures: \['fig4'\]"):
        trun.main(["--quick", "--only", "fig4", "--device", "cpu"])
    assert "# fig4 FAILED" in capsys.readouterr().out


def _cut_rounds(mod, monkeypatch):
    for name in ("T", "T_QUICK", "T_ROUNDS", "T_ROUNDS_QUICK"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, TWIN_ROUNDS)
    if mod.__name__.endswith("engine_bench"):
        monkeypatch.setattr(mod, "REPEATS", 1)
        monkeypatch.setattr(mod, "CHUNK", 2)
        monkeypatch.setattr(mod, "ENGINE_CHUNK", 2)


@pytest.mark.parametrize("name", sorted(trun.MODULES))
def test_twin_runs_quick_on_cpu(name, monkeypatch, capsys):
    """Each twin's ``main(quick=True)`` at 2 rounds: its header and the
    settings columns of its rows are the reference's quick ones."""
    mod = trun.MODULES[name]
    _cut_rounds(mod, monkeypatch)
    if name == "serving":
        # its flatness check reads wall clocks, which a loaded CPU makes
        # noise of: the card holds it (chip_smoke.py phase 16 (d))
        monkeypatch.setattr(mod, "FLAT_RATIO", 0.0)
    mod.main(quick=True, device="cpu")
    # a module's closing notes (``#`` lines) are not rows
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if not ln.startswith("#")]
    if name == "engine":
        header = lines[0].split(",")
        rows = [ln.split(",") for ln in lines[1:15]]
        report = json.loads("\n".join(lines[15:]))
        assert [r[:4] for r in rows] == [
            ["lr", "sync", "host_loop", "1"],
            ["lr", "sync", "chunked_host", "2"],
            ["lr", "sync", "chunked_device", "2"],
            ["lr", "async", "per_update", "1"],
            ["lr", "async", "chunked_host", "2"],
            ["lr", "async", "chunked_device", "2"]] + [
            [kind, engine, layout, chunk]
            for kind in ("lr", "mlp")
            for engine, chunk in (("layout", "2"), ("layout_engine", "1"))
            for layout in ("tree", "flat")]
        rates = report["sync"]["lr"]
        assert rates["host_loop_rounds_per_s"] > 0
        assert rates["chunked_host_rounds_per_s"] > 0
        assert rates["chunked_device_rounds_per_s"] > 0
        rates = report["async"]["lr"]
        assert rates["per_update_updates_per_s"] > 0
        assert rates["chunked_host_updates_per_s"] > 0
        assert rates["chunked_device_updates_per_s"] > 0
        for kind in ("lr", "mlp"):
            rates = report["layout"][kind]
            assert rates["tree_rounds_per_s"] > 0
            assert rates["flat_rounds_per_s"] > 0
            assert rates["engine_tree_rounds_per_s"] > 0
            assert rates["engine_flat_rounds_per_s"] > 0
            assert 0.0 <= rates["grad_fraction_tree"] < 1.0
        assert report["meta"]["device_name"] == "cpu"
        assert "not_run" not in report["meta"]
        assert header[0] == "task"
        return
    if name == "serving":
        header = lines[0].split(",")
        rows = [ln.split(",") for ln in lines[1:7]]
        report = json.loads("\n".join(lines[7:]))
        assert header[:3] == ["personalizer", "M", "requests"]
        assert [r[:3] for r in rows] == [
            ["lowrank", "32", "16"], ["lowrank", "1000", "16"],
            ["lowrank", "100000", "16"], ["none", "32", "16"],
            ["nu", "32", "16"], ["lowrank", "32", "16"]]
        for r in (report["population_sweep"]
                  + report["personalizer_kinds"]):
            assert r["n_requests"] == 16 and r["requests_per_s"] > 0
        assert report["hot_swap"]["mid_stream_versions_served"] == [1, 2]
        assert report["meta"]["device"] == "cpu"
        return
    header, *rows = [ln.split(",") for ln in lines]
    # table_async's and scenario's rows start with the algorithm,
    # compression's with the mode, robust's with the attack, as the
    # reference's do
    assert rows and (name in ("table_async", "compression", "scenario",
                              "robust")
                     or all(r[0] == name.split("_")[0] or r[0] == name
                            for r in rows))
    ref = REFERENCE["modules"].get(name)
    if ref is None:
        assert all(len(r) == len(header) for r in rows)
        return
    assert header == ref["header"]
    assert len(rows) == len(ref["rows"])
    # the settings columns line up; numbers are the run's own at 2 rounds
    n_key = {"thm1": 2, "table1": 3, "table2": 3, "fig2": 3, "fig3": 3,
             "fig4": 4, "fairness": 2, "server_opt": 4, "table_async": 4,
             "compression": 3, "scenario": 3, "robust": 2,
             "int8_nu": 2}[name]
    assert [r[:n_key] for r in rows] == [r[:n_key] for r in ref["rows"]]
    for r in rows:
        # robust's survival column is a word
        assert all(np.isfinite(float(v)) for v in r[n_key:]
                   if v and v not in ("-", "yes", "DIVERGED")
                   and not v.startswith(">"))


def test_reference_quick_rows_are_current():
    """The committed reference rows are what the JAX modules print now:
    thm1, table1 and server_opt regenerated (the rest by the same code)."""
    names = ("thm1", "table1", "server_opt")
    fresh = _reference_quick.generate(names)
    assert REFERENCE["command"] == _reference_quick.COMMAND
    assert set(REFERENCE["modules"]) == set(_reference_quick.MODULES)
    for name in names:
        assert fresh["modules"][name] == REFERENCE["modules"][name], name


def test_continuous_batching_twin_on_cpu(capsys):
    out = continuous_batching.main(["--device", "cpu"])
    done = sorted(out["completions"], key=lambda c: c.uid)
    assert [(c.prompt_len, len(c.tokens)) for c in done] == \
        continuous_batching.REQUESTS
    # the reference example's schedule: 81 tokens in 26 ticks
    assert (out["tokens"], out["ticks"]) == (81, 26)
    assert out["tokens_per_tick"] > 1.2
    assert "tokens/tick" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(trun.MODULES) + ["continuous"])
def test_twins_without_device_raise_where_no_cuda(name):
    """Every twin runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if name == "continuous":
            continuous_batching.main([])
        else:
            trun.MODULES[name].main(quick=True)


def test_relabelled_rerun_is_the_same_run_in_other_roundings():
    """chip_smoke phase 12's probe for the mlp's ReLU branches: the model
    with its input features and hidden units relabelled computes the same
    function, and a relabelled rerun, mapped back, is the plain run up to
    float32 rounding."""
    import chip_smoke
    from repro_torch.models.simple import _mlp_logits
    with np.load(common.MLP_INIT_KEY0) as f:
        params = {k: torch.from_numpy(f[k]) for k in f.files}
    gen = torch.Generator().manual_seed(3)
    feats, hidden = torch.randperm(60, generator=gen), torch.randperm(
        64, generator=gen)
    moved = chip_smoke._relabelled(params, feats, hidden)
    back = chip_smoke._relabelled(moved, torch.argsort(feats),
                                  torch.argsort(hidden))
    for k in params:
        assert torch.equal(back[k], params[k])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 60)).astype(np.float32))
    torch.testing.assert_close(_mlp_logits(moved, x[:, feats]),
                               _mlp_logits(params, x), rtol=1e-5, atol=1e-5)
    with chip_smoke._RecordedRuns() as runs:
        common.run_sim(common.make_task("mlp", noniid=True, device="cpu"),
                       "fedagrac", 2, k_mean=5, lam=0.5)
    plain = chip_smoke._trajectory(runs[0])
    probe = chip_smoke._cpu_rerun(runs[0], relabel_seed=1)
    np.testing.assert_allclose(probe["loss"], plain["loss"], **LOSS_TOL)
    torch.testing.assert_close(probe["params"], plain["params"], rtol=1e-5,
                               atol=2e-6)
    assert FederatedSimulation.run.__name__ == "run"
    assert "_RecordedRuns" not in FederatedSimulation.run.__qualname__
