"""The port's serving half of the launch layer (``repro_torch.launch``,
``repro_torch.dist``) against the reference's single-device serving.

One ``gloo`` group of 4 ranks on a ``(2, 2)`` ``("data", "model")`` CPU
mesh (``tests/_torch_mesh_worker.py``, spawned once for the file under a
hard limit of GROUP_LIMIT_S) serves reduced llama3-8b and gemma-2b (MQA:
its one kv head shared by the model axis) from the reference's weights:
``build_prefill`` (B 8), ``build_decode`` (teacher-forced steps), the
``long`` kind (B 1, the cache's sequence over ``data``) and
``build_personalized_decode``, a ``sharding_fn`` restore and an
out-of-scope family's refusal.  Each result, made whole, is held to the
reference's ``serve_prefill`` / ``serve_decode`` / ``personalized_decode``
on one device within the reference's sharded-decode tolerance
(``tests/test_dist_spmd.py``), and every leaf the specs shard is sharded
on every rank.  The one-process checks run the rules without a group.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.core import flat as jflat  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import personalized as jpers  # noqa: E402
from repro_torch import dist  # noqa: E402
from repro_torch.checkpoint import serialize  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import distributed, mesh as mesh_lib  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_mesh_worker.py")
WORLD = 4
GROUP_LIMIT_S = 120
RTOL = ATOL = 2e-4          # tests/test_dist_spmd.py's sharded decode
ARCHS = ("llama3-8b", "gemma-2b")
B, S, L, STEPS = 8, 24, 32, 3


def _cfg(name):
    return dataclasses.replace(reduced(get_arch(name), n_layers=2,
                                       d_model=128), vocab=256)


def _inputs(root: Path) -> dict:
    """The reference's weights (written under ``root`` in the port's
    checkpoint format), seeded prompts, teacher-forced steps and
    personalized deltas (``inputs.npz``)."""
    jdist.unset_mesh()
    rng = np.random.default_rng(0)
    inputs, params = {"cache_len": np.int64(L)}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        params[arch] = JM.init_params(jax.random.PRNGKey(0), cfg)
        serialize.save(str(root / f"{arch}.msgpack"), lm_params_from_numpy(
            jax.tree.map(np.asarray, params[arch]), "cpu"))
        inputs[f"{arch}/prompt"] = rng.integers(
            1, cfg.vocab, (B, S)).astype(np.int32)
        inputs[f"{arch}/steps"] = rng.integers(
            1, cfg.vocab, (B, STEPS)).astype(np.int32)
    p = jflat.make_flat_spec(params["llama3-8b"]).p
    deltas = (1e-2 * rng.standard_normal((B, p))).astype(np.float32)
    deltas[:, jflat.make_flat_spec(params["llama3-8b"]).n:] = 0
    inputs["deltas"] = deltas
    np.savez(root / "inputs.npz", **inputs)
    return {"params": params, **inputs}


def _expected(inp: dict) -> dict:
    """The reference's single-device results on the same inputs."""
    jdist.unset_mesh()
    ref = {}
    for arch in ARCHS:
        cfg, params = _cfg(arch), inp["params"][arch]
        prefill = jax.jit(JM.serve_prefill, static_argnums=2)
        decode = jax.jit(JM.serve_decode, static_argnums=4)
        prompt, steps = inp[f"{arch}/prompt"], inp[f"{arch}/steps"]
        rows = (slice(None), slice(0, 1)) if arch == "llama3-8b" else (
            slice(None),)
        for key, r in zip((arch, "long"), rows):
            logits, caches = prefill(
                params, {"tokens": jnp.asarray(prompt[r])}, cfg,
                JM.init_caches(cfg, prompt[r].shape[0], L, jnp.float32))
            if key == arch:
                ref[f"{arch}/prefill"] = np.asarray(logits)
                prefilled = caches
            got = []
            for i in range(STEPS):
                logits, caches = decode(
                    params, {"tokens": jnp.asarray(steps[r][:, i:i + 1])},
                    caches, S + i, cfg)
                got.append(np.asarray(logits))
            ref[f"{arch}/decode" if key == arch else key] = np.stack(got, 1)
        if arch == "llama3-8b":
            jspec = jflat.make_flat_spec(params)
            rows = jflat.ravel(jspec, params)[None] + jnp.asarray(
                inp["deltas"])
            logits, _ = jax.jit(jpers.personalized_decode,
                                static_argnums=(0, 1))(
                jspec, cfg, rows, jnp.asarray(steps[:, :1]), prefilled,
                jnp.full((B,), S, jnp.int32))
            ref["personalized"] = np.asarray(logits)
    return ref


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank group's results beside the reference's, computed while
    the ranks run; past GROUP_LIMIT_S every rank is killed and the fixture
    fails."""
    root = tmp_path_factory.mktemp("mesh")
    inp = _inputs(root)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r),
                               str(WORLD), str(root)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + GROUP_LIMIT_S
    try:
        ref = _expected(inp)
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    tails = {r: (root / f"rank{r}.log").read_text()[-3000:]
             for r in range(WORLD)}
    if hung:
        pytest.fail(f"the gloo group did not finish in {GROUP_LIMIT_S} s; "
                    f"logs: {tails}")
    bad = {r: tails[r] for r, p in enumerate(procs) if p.returncode}
    assert not bad, f"ranks failed: {bad}"
    checks = [json.loads((root / f"checks_{r}.json").read_text())
              for r in range(WORLD)]
    with np.load(root / "out.npz") as out:
        return {"ref": ref, "out": dict(out), "checks": checks}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_matches_reference(group, arch):
    _close(group["out"][f"{arch}/prefill"], group["ref"][f"{arch}/prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_matches_reference(group, arch):
    _close(group["out"][f"{arch}/decode"], group["ref"][f"{arch}/decode"])


def test_mesh_long_decode_matches_reference(group):
    """B 1, the cache's 32 slots over the 2 data ranks: the decode writes
    slots 24-26, all on the second data rank, and reads both halves."""
    _close(group["out"]["long"], group["ref"]["long"])


def test_mesh_personalized_decode_matches_reference(group):
    _close(group["out"]["personalized"], group["ref"]["personalized"])


def test_mesh_sharding_fn_restore(group):
    """The restore straight onto the mesh serves the prefill the placed
    weights served, bit for bit."""
    np.testing.assert_array_equal(group["out"]["restored_prefill"],
                                  group["out"]["llama3-8b/prefill"])


def test_mesh_sharded_leaves_are_sharded_on_every_rank(group):
    """Every leaf whose spec shards it holds only its share on every rank:
    weights, the prefill's and decode's caches (batch over data, heads over
    model), the long kind's (sequence over data) and the restored
    weights."""
    for r, ch in enumerate(group["checks"]):
        assert not ch["fails"], (r, ch["fails"][:5])
        counts = ch["sharded_leaves"]
        assert counts["llama3-8b/params"] >= 9, counts
        for key in ("llama3-8b/prefill_caches", "llama3-8b/decode_caches",
                    "gemma-2b/decode_caches", "long_caches", "restored",
                    "personalized_caches"):
            assert counts[key] >= 1, (key, counts)


def test_mesh_refuses_family_outside_scope(group):
    msg = str(group["out"]["refusal"])
    assert "A15" in msg and "granite-moe-1b-a400m" in msg, msg


def test_mesh_host_client_slice(group):
    """One host: both data slices' clients are local."""
    assert tuple(group["out"]["host_slice"]) == (0, 2)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def test_constrain_without_mesh_does_nothing():
    dist.unset_mesh()
    x = torch.randn(2, 3)
    assert dist.constrain(x, "dp", "mp") is x
    assert dist.axis_size("mp") == 1


def test_use_mesh_restores_previous_mesh_and_rules():
    class Fake:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}
    outer, inner = Fake(), Fake()
    dist.set_mesh_rules(outer, {"mp": ("model",)})
    try:
        with dist.use_mesh(inner, {"mp": (), "dp": ("data",)}):
            assert dist.current_mesh() is inner
            assert dist.axis_size("mp") == 1 and dist.axis_size("dp") == 2
            # plain tensors pass, the rank check still holds
            with pytest.raises(ValueError, match="rank-2"):
                dist.constrain(torch.zeros(2, 2), "dp")
        assert dist.current_mesh() is outer and dist.axis_size("mp") == 4
    finally:
        dist.unset_mesh()
    assert dist.current_mesh() is None


def test_bootstrap_without_cluster_env_does_nothing(monkeypatch):
    import torch.distributed as tdist
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    was = tdist.is_initialized()
    distributed.bootstrap()
    assert tdist.is_initialized() == was
    assert distributed.is_coordinator()
    distributed.sync_global_devices("noop")


def test_one_rank_mesh_and_world_mismatch():
    """A (1, 1) CPU mesh in a world of one: every client is local; a mesh
    the world cannot fill raises, naming the count."""
    import torch.distributed as tdist
    started = not tdist.is_initialized()
    try:
        mesh = mesh_lib.make_local_mesh(1, 1, device_type="cpu")
        assert distributed.host_client_slice(mesh) == (0, 1)
        assert dist.view(mesh).shape == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_lib.make_local_mesh(2, 2, device_type="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh_lib.make_production_mesh(device_type="cpu")
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()
