"""Checkpoints in the port (checkpoint/_msgpack.py, checkpoint/serialize.py,
the simulation's publish hooks) against the JAX package on the CPU.

* ``_msgpack.packb`` writes ``msgpack.packb(obj, use_bin_type=True)``'s
  bytes for every form of the subset and for the reference's checkpoint
  payloads, and ``unpackb`` reads msgpack's output.
* A simulation state saved by either package loads in the other, bit for
  bit, and the files of the same arrays are byte-identical.
* The port twins of tests/test_checkpoint_roundtrip.py's flat, non-serving
  tests: the full state with ``ef_up`` / ``ef_nu``, ``load_raw``,
  ``publish_snapshot``, the snapshot file, the publish hook, the health
  vectors, cohort absentees and a quarantine across a resume, at a rate
  whose corrupt set is not empty (asserted first: at M = 8 the reference's
  rate 0.25 draws none, ROADMAP C2).
* A resumed run equals the unbroken one, bit for bit: ``run(6)``, save,
  load into a fresh simulation, ``run(6)`` against two ``run(6)`` calls on
  one simulation (an int8 wire, a defended cohort under an attack, on the
  device batcher).
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401
msgpack = pytest.importorskip("msgpack")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import serialize as jserialize  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.data import DeviceBatcher as JDeviceBatcher  # noqa: E402
from repro.data import fedprox_synthetic as j_synthetic  # noqa: E402
from repro.fed import FederatedSimulation as JSimulation  # noqa: E402
from repro.models.simple import lr_loss as j_lr_loss  # noqa: E402
from repro_torch.checkpoint import _msgpack, serialize  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.data import DeviceBatcher, fedprox_synthetic  # noqa: E402
from repro_torch.fed import FederatedSimulation, scenarios  # noqa: E402
from repro_torch.models.simple import lr_loss  # noqa: E402

M = 8
# the numpy seed the reference's fedprox_synthetic draws from at PRNGKey(0)
DATA_SEED = 31327077
# at M = 8 the corrupt set of seed 0 is {4, 7} at this rate (0.25: empty)
RATE = 0.4
_HEALTH_KEYS = ("hz_nonfinite", "hz_mean", "hz_var", "hz_count", "hz_until")


@pytest.fixture(scope="module")
def data():
    return fedprox_synthetic(DATA_SEED, M, alpha=1.0, beta=1.0)


def _batcher(data):
    return DeviceBatcher(*data, batch_size=8, seed=0, device="cpu")


def _fed(**kw):
    kw.setdefault("algorithm", "fedagrac")
    kw.setdefault("k_mean", 5)
    kw.setdefault("k_var", 2.0)
    kw.setdefault("k_mode", "random")
    return dict(n_clients=M, lr=0.05, calibration_rate=0.5,
                param_layout="flat", **kw)


def _sim(data, **kw):
    return FederatedSimulation(
        lr_loss, {"w": torch.zeros(60, 10), "b": torch.zeros(10)},
        FedConfig(**_fed(**kw)), _batcher(data), device="cpu")


def _states_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

SUBSET = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
          2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
          -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, "", "a" * 31,
          "a" * 32, "é" * 40, "x" * 300, "x" * 70_000, b"", b"a" * 255,
          b"a" * 256, b"b" * 70_000, [], list(range(15)), list(range(16)),
          list(range(70_000)), (1, "a"), {}, {"a": 1},
          {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
          {str(i): [i] for i in range(70_000)}]


@pytest.mark.parametrize("obj", SUBSET, ids=lambda o: type(o).__name__ + (
    str(len(o)) if hasattr(o, "__len__") else repr(o)))
def test_msgpack_subset_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    got = _msgpack.unpackb(want)
    expect = msgpack.unpackb(want, raw=False)
    if isinstance(got, memoryview):
        got = bytes(got)
    assert got == (list(expect) if isinstance(expect, tuple) else expect)


def test_msgpack_refuses_outside_the_subset():
    for obj in (1.5, {1: 2}.keys(), 2 ** 64, -2 ** 63 - 1, {"a": {1.0}}):
        with pytest.raises((TypeError, OverflowError)):
            _msgpack.packb(obj)
    with pytest.raises(ValueError, match="subset"):
        _msgpack.unpackb(msgpack.packb(1.5))


def test_reference_payload_bytes_equal(tmp_path):
    """The reference's checkpoint of a tree of every dtype the states hold
    (float32, int32, bool, bfloat16, an empty leaf, nested lists) and the
    port's of the same arrays are the same file."""
    rng = np.random.default_rng(0)
    arrays = {"params": rng.standard_normal((3, 70)).astype(np.float32),
              "round": np.int32(7),
              "seg": [rng.integers(-5, 5, (4,)).astype(np.int32),
                      np.zeros((0, 3), np.float32),
                      np.array([True, False])],
              "half": rng.standard_normal(5).astype(np.float32)}
    jtree = jax.tree.map(jnp.asarray, arrays)
    jtree["half"] = jtree["half"].astype(jnp.bfloat16)
    ttree = jax.tree.map(torch.from_numpy, {**arrays, "round": np.asarray(
        arrays["round"])})
    ttree["half"] = ttree["half"].to(torch.bfloat16)
    jserialize.save(str(tmp_path / "j.msgpack"), jtree)
    serialize.save(str(tmp_path / "t.msgpack"), ttree)
    assert ((tmp_path / "j.msgpack").read_bytes()
            == (tmp_path / "t.msgpack").read_bytes())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_state_files_load_across_packages(data, tmp_path):
    kw = _fed(compressor="int8", scenario="nan_inject", scenario_rate=RATE,
              defense="trimmed_mean", quarantine_window=3)
    assert scenarios._corrupt_set(M, 0, RATE).any()
    jdata, jparts = j_synthetic(jax.random.PRNGKey(0), M, alpha=1.0,
                                beta=1.0)
    jsim = JSimulation(j_lr_loss, {"w": jnp.zeros((60, 10)),
                                   "b": jnp.zeros((10,))},
                       JFedConfig(**kw), JDeviceBatcher(jdata, jparts, 8))
    jsim.run(3, eval_every=3)
    tsim = _sim(data, **{k: v for k, v in kw.items()
                         if k not in _fed()})
    tsim.run(3, eval_every=3)
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jserialize.save(jpath, jsim.state)
    serialize.save(tpath, tsim.state)
    into_port = serialize.load(jpath, tsim.state)
    into_ref = jserialize.load(tpath, jsim.state)
    for key in jsim.state:
        np.testing.assert_array_equal(into_port[key].numpy(),
                                      np.asarray(jsim.state[key]))
        assert into_port[key].dtype == tsim.state[key].dtype, key
        np.testing.assert_array_equal(np.asarray(into_ref[key]),
                                      tsim.state[key].numpy())
    # the port writes the reference's file for the reference's arrays
    serialize.save(str(tmp_path / "again.msgpack"), into_port)
    assert ((tmp_path / "again.msgpack").read_bytes()
            == (tmp_path / "j.msgpack").read_bytes())


def test_load_raises_reference_messages(data, tmp_path):
    sim = _sim(data)
    path = str(tmp_path / "s.msgpack")
    serialize.save(path, sim.state)
    jlike = jax.tree.map(np.asarray, {k: v.numpy()
                                      for k, v in sim.state.items()})
    for like, tlike in (({"missing": jnp.zeros(1)},
                         {"missing": torch.zeros(1)}),
                        ({"params": jnp.zeros(3)},
                         {"params": torch.zeros(3)})):
        with pytest.raises((KeyError, ValueError)) as ref:
            jserialize.load(path, like)
        want = (ref.type, str(ref.value))
        with pytest.raises(want[0]) as got:
            serialize.load(path, tlike)
        assert str(got.value) == want[1]
    plain = serialize.load(path, sim.state)
    assert sorted(plain) == sorted(jlike)
    # a sharding_fn restores equal to the unsharded restore: leaves it
    # gives no placement as they are, and on a one-rank CPU mesh the
    # others as DTensors over the same values
    keys = []

    def none(key, arr):
        keys.append(key)
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
        return None
    got = serialize.load(path, sim.state, sharding_fn=none)
    assert keys == sorted(jlike)
    for k in plain:
        assert torch.equal(got[k], plain[k]), k
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_local_mesh
    started = not tdist.is_initialized()
    try:
        mesh = make_local_mesh(1, 1, device_type="cpu")
        got = serialize.load(path, sim.state, sharding_fn=lambda k, a: (
            mesh, (Replicate(), Replicate())))
        for k in plain:
            assert isinstance(got[k], DTensor), k
            assert torch.equal(got[k].full_tensor(), plain[k]), k
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's round-trip contract, on the port
# ---------------------------------------------------------------------------

def test_full_state_roundtrips_bit_exact(data, tmp_path):
    sim = _sim(data, compressor="int8")
    sim.run(3, eval_every=3)
    path = str(tmp_path / "state.msgpack")
    serialize.save(path, sim.state)
    restored = serialize.load(path, sim.state)
    for key in ("params", "nu", "nu_i", "ef_up", "ef_nu"):
        assert key in restored
    _states_equal(sim.state, restored)


def test_load_raw_matches_structured_load(data, tmp_path):
    sim = _sim(data)
    sim.run(2, eval_every=2)
    path = str(tmp_path / "state.msgpack")
    serialize.save(path, sim.state)
    raw = serialize.load_raw(path)
    structured = serialize.load(path, sim.state)
    assert sorted(raw) == sorted(structured)
    for key in raw:
        assert raw[key].dtype == structured[key].dtype
        assert torch.equal(raw[key], structured[key])


def test_publish_snapshot_carries_training_state(data):
    sim = _sim(data)
    sim.run(2, eval_every=2)
    snap = sim.publish_snapshot()
    spec = sim.flat_spec
    assert int(snap["version"]) == 2
    assert snap["flat_master"].shape == (spec.p,)
    assert snap["nu"].shape == (spec.p,)
    assert snap["nu_i"].shape == (M, spec.p)
    got = flat.unravel(spec, snap["flat_master"])
    for key, want in sim.params.items():
        assert torch.equal(got[key], want)
    # the snapshot owns its buffers: later rounds do not move it
    before = snap["nu_i"].clone()
    sim.run(1)
    assert torch.equal(snap["nu_i"], before)


def test_snapshot_file_roundtrip(data, tmp_path):
    sim = _sim(data)
    sim.run(2, eval_every=2)
    path = str(tmp_path / "snap.msgpack")
    saved = sim.save_snapshot(path)
    loaded = serialize.load_raw(path)
    assert sorted(loaded) == sorted(saved)
    assert int(loaded["version"]) == int(saved["version"]) == 2
    for key in ("flat_master", "nu", "nu_i"):
        assert torch.equal(loaded[key], saved[key])
    # the reference reads the port's snapshot
    jloaded = jserialize.load_raw(path)
    np.testing.assert_array_equal(jloaded["nu_i"], saved["nu_i"].numpy())


def test_publish_hook_fires_on_round_boundaries(data):
    seen = []
    sim = _sim(data)
    sim.run(6, eval_every=6, publish_fn=seen.append, publish_every=2)
    assert [int(s["version"]) for s in seen] == [2, 4, 6]
    assert all(s["flat_master"].shape == seen[0]["flat_master"].shape
               for s in seen)
    assert not torch.equal(seen[0]["flat_master"], seen[-1]["flat_master"])
    # each publication is the state at its round: a run stopped there
    again = _sim(data)
    again.run(4, eval_every=4)
    assert torch.equal(seen[1]["flat_master"], again.state["params"])


def test_health_state_roundtrips_bit_exact(data, tmp_path):
    assert scenarios._corrupt_set(M, 0, RATE).any()
    sim = _sim(data, scenario="nan_inject", scenario_rate=RATE,
               defense="trimmed_mean", quarantine_window=3)
    sim.run(3, eval_every=3)
    assert sim.state["hz_nonfinite"].sum() > 0
    path = str(tmp_path / "robust.msgpack")
    serialize.save(path, sim.state)
    restored = serialize.load(path, sim.state)
    for key in _HEALTH_KEYS:
        assert key in restored
    _states_equal(sim.state, restored)


def test_cohort_absentee_health_rows_untouched(data):
    assert scenarios._corrupt_set(M, 0, RATE).any()
    sim = _sim(data, cohort_size=3, scenario="nan_inject",
               scenario_rate=RATE, defense="median", quarantine_window=4)
    before = {k: sim.state[k].clone() for k in _HEALTH_KEYS}
    sim.run(1)
    ids = set(int(i) for i in sim.population.host_cohort(0)[0])
    assert len(ids) == 3
    for i in range(M):
        if i not in ids:
            for k in _HEALTH_KEYS:
                assert before[k][i] == sim.state[k][i], (k, i)


def test_quarantine_survives_resume(data, tmp_path):
    assert scenarios._corrupt_set(M, 0, RATE).any()
    kw = dict(scenario="nan_inject", scenario_rate=RATE,
              defense="trimmed_mean", quarantine_window=8)
    sim = _sim(data, **kw)
    sim.run(2, eval_every=2)
    assert sim.state["hz_until"].max() > 0
    path = str(tmp_path / "quar.msgpack")
    serialize.save(path, sim.state)
    sim2 = _sim(data, **kw)
    sim2.state = serialize.load(path, sim2.state)
    _states_equal(sim.state, sim2.state)
    hist = sim2.run(1, eval_every=1)
    assert hist.quarantined and hist.quarantined[0] > 0


@pytest.mark.parametrize("kw", [
    dict(compressor="int8", cohort_size=4, scenario="scale_attack",
         scenario_rate=RATE, defense="trimmed_mean", quarantine_window=4),
    dict(scenario="garbage", scenario_rate=RATE, defense="krum",
         quarantine_window=2)], ids=["int8_cohort_scale", "garbage"])
def test_resume_equals_two_runs(data, tmp_path, kw):
    """The saved state carries everything the next run reads — its round
    counter keys the attack's noise — so a fresh simulation restored from
    the file continues as the saved one does."""
    assert scenarios._corrupt_set(M, 0, RATE).any()
    whole = _sim(data, **kw)
    whole.run(6, chunk_rounds=3)
    path = str(tmp_path / "mid.msgpack")
    serialize.save(path, whole.state)
    h1 = whole.run(6, chunk_rounds=3)
    resumed = _sim(data, **kw)
    resumed.state = serialize.load(path, resumed.state)
    h2 = resumed.run(6, chunk_rounds=3)
    assert h1.loss == h2.loss
    _states_equal(whole.state, resumed.state)
    assert int(resumed.state["round"]) == 12
