"""The port's multi-head latent attention (``mla_attention``,
``mla_decode_absorbed``, MLA's weights and caches) against the
reference's (``repro.models.attention``) on the CPU, with the reference's
weights carried across and inputs drawn with numpy.

deepseek-v2-lite reduced (d 128, 2 heads, head dim 64; MLA kv_lora 32,
dn 64, dr 16, dv 64, so the rope part dr is below the head dim and takes
the first dr / 2 frequencies of the head dim's table), without its MoE
block.  All four branches — no cache (the reference's q-block scan at S
= 40, its Pallas kernel in interpret mode at S = 128), a prefill into a
cache, the naive decode (``absorb=False``) and the absorbed one — with
the cache contents after each.  Float32 outputs and caches agree within
TOL (the same float32 operations, summed in other orders); a bfloat16
absorbed decode within BF16_TOL of the output's largest entry (the port
takes each latent product in float32 on operands already rounded to
bfloat16, the reference's ``preferred_element_type=float32``; the two
differ only in the order of the float32 sums, then one bfloat16
rounding)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import dist  # noqa: E402
from repro.configs.base import reduced  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.configs.base import reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401

TOL = 2e-5
BF16_TOL = 2.0 ** -7
NAME = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def _no_mesh():
    dist.unset_mesh()          # C4: a mesh left set by another test file


def _cfgs(absorb=True, dtype="float32"):
    def cut(cfg):
        return dataclasses.replace(
            cfg, moe=None, dtype=dtype,
            mla=dataclasses.replace(cfg.mla, absorb=absorb))
    return (cut(reduced(get_arch(NAME))), cut(treduced(tregistry.get_arch(
        NAME))))


def _weights(cfg, dtype=jnp.float32, seed=0):
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg, dtype)
    # a non-zero ckv norm, so that its (1 + scale) gain is exercised
    p["ckv_norm"] = (0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), p["ckv_norm"].shape)).astype(dtype)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _x(B, S, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        dtype)


def _angles(cfg, tcfg, pos):
    return (jlayers.rope_angles(jnp.asarray(pos), cfg.resolved_head_dim,
                                cfg.rope_theta),
            tlayers.rope_angles(torch.from_numpy(pos),
                                tcfg.resolved_head_dim, tcfg.rope_theta))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _same_cache(tc, c):
    c = jax.tree.map(np.asarray, c)
    assert sorted(tc) == sorted(c) == ["ckv", "idx", "krope", "pos"]
    for k in ("pos", "idx"):
        np.testing.assert_array_equal(tc[k].numpy(), c[k])
    for k in ("ckv", "krope"):
        _close(tc[k], c[k])


def _run(cfg, tcfg, p, tp, x, pos, cache=None, tcache=None):
    ang, tang = _angles(cfg, tcfg, pos)
    want, new = jax.jit(lambda x, a, q, c: jattn.mla_attention(
        p, x, cfg, angles=a, q_pos=q, cache=c))(
            jnp.asarray(x), ang, jnp.asarray(pos), cache)
    got, tnew = tattn.attention(tp, torch.from_numpy(x), tcfg, angles=tang,
                                q_pos=torch.from_numpy(pos), cache=tcache)
    return want, new, got, tnew


def test_init_cache_matches():
    cfg, tcfg = _cfgs()
    want = jax.tree.map(np.asarray, jattn.init_cache(cfg, 3, 24,
                                                     jnp.float32))
    got = tattn.init_cache(tcfg, 3, 24, torch.float32, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    stacked = tattn.init_cache(tcfg, 3, 24, torch.bfloat16, "cpu",
                               lead=(2, 1))
    assert stacked["ckv"].shape == (2, 1, 3, 24, cfg.mla.kv_lora_rank)
    assert stacked["krope"].dtype == torch.bfloat16


@pytest.mark.parametrize("S,kernel", [(40, False), (128, True)])
def test_in_flight_branch_matches(S, kernel, monkeypatch):
    """No cache: the reference's q-block scan (S = 40) or its Pallas
    kernel in interpret mode (S = 128), against the port's flash plain
    version at Dqk = dn + dr = 80, Dv = 64."""
    if kernel:
        monkeypatch.setenv("REPRO_FLASH_ATTENTION", "interpret")
    cfg, tcfg = _cfgs()
    p, tp = _weights(cfg)
    pos = np.arange(S, dtype=np.int32)
    want, new, got, tnew = _run(cfg, tcfg, p, tp,
                                _x(2, S, cfg.d_model, 1), pos)
    assert new is None and tnew is None
    _close(got, want)


@pytest.mark.parametrize("absorb", [True, False], ids=["absorbed", "naive"])
def test_prefill_and_decode_branches_match(absorb):
    """A prefill of 20 tokens into an empty 32-slot cache, then three
    decode steps of two rows at different positions (per-row q_pos), the
    cache contents after each."""
    cfg, tcfg = _cfgs(absorb)
    p, tp = _weights(cfg, seed=2)
    cache = jattn.init_cache(cfg, 2, 32, jnp.float32)
    tcache = tattn.init_cache(tcfg, 2, 32, torch.float32, "cpu")
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want, cache, got, tcache = _run(cfg, tcfg, p, tp,
                                    _x(2, 20, cfg.d_model, 3), pos,
                                    cache, tcache)
    _close(got, want)
    _same_cache(tcache, cache)
    offs = np.array([20, 20], np.int32)
    for step in range(3):
        pos = offs[:, None].copy()
        want, cache, got, tcache = _run(cfg, tcfg, p, tp,
                                        _x(2, 1, cfg.d_model, 4 + step), pos,
                                        cache, tcache)
        _close(got, want)
        _same_cache(tcache, cache)
        offs = offs + np.array([1, 2], np.int32)


def _random_cache(cfg, B, size, seed, dtype=np.float32):
    """A filled cache with empty slots (pos −1) and a hole in row 1."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    pos = np.tile(np.arange(size, dtype=np.int32), (B, 1))
    pos[1, size // 2:] = -1
    pos[0, 3] = -1
    return {"ckv": rng.standard_normal((B, size, m.kv_lora_rank)).astype(
                dtype),
            "krope": rng.standard_normal((B, size, m.qk_rope_head_dim)
                                         ).astype(dtype),
            "pos": pos, "idx": np.full((B,), size, np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_absorbed_matches(dtype):
    """The latent-space decode on its own, against the reference's, on a
    cache with empty slots: float32 within TOL, bfloat16 within BF16_TOL
    of the output's largest entry."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg, tcfg = _cfgs(dtype=dtype)
    p, tp = _weights(cfg, dtype=jdt, seed=5)
    m, H = cfg.mla, cfg.n_heads
    cache = _random_cache(cfg, 2, 24, 6)
    cache = {k: (v.astype(jdt) if v.dtype == np.float32 else v)
             for k, v in cache.items()}
    rng = np.random.default_rng(7)
    q_nope = rng.standard_normal((2, H, m.qk_nope_head_dim)).astype(jdt)
    q_rope = rng.standard_normal((2, H, m.qk_rope_head_dim)).astype(jdt)
    q_pos = np.array([23, 9], np.int32)
    want = jattn.mla_decode_absorbed(
        p, cfg, jnp.asarray(q_nope), jnp.asarray(q_rope),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(q_pos),
        seq_shard=False)
    got = tattn.mla_decode_absorbed(
        tp, tcfg, params_from_numpy(q_nope, "cpu"),
        params_from_numpy(q_rope, "cpu"), params_from_numpy(cache, "cpu"),
        torch.from_numpy(q_pos))
    assert got.shape == (2, 1, H, m.v_head_dim)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close(got, want)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max(), err


def test_absorbed_decode_equals_naive():
    """The two decodes of the port agree (exact arithmetic makes them
    equal: W_uk and W_uv are linear), step after step."""
    cfgs = {absorb: _cfgs(absorb)[1] for absorb in (True, False)}
    _, tp = _weights(cfgs[True], seed=8)
    caches = {a: tattn.init_cache(cfgs[a], 2, 32, torch.float32, "cpu")
              for a in cfgs}
    x = torch.from_numpy(_x(2, 12, cfgs[True].d_model, 9))
    pos = torch.arange(12, dtype=torch.int32)
    for step in range(4):
        outs = {}
        for a, tcfg in cfgs.items():
            ang = tlayers.rope_angles(pos, tcfg.resolved_head_dim,
                                      tcfg.rope_theta)
            outs[a], caches[a] = tattn.attention(
                tp, x, tcfg, angles=ang, q_pos=pos, cache=caches[a])
        _close(outs[True], outs[False].numpy())
        x = x[:, :1] * 0.5 + 0.1 * step
        pos = torch.full((1,), 12 + step, dtype=torch.int32)


def test_rope_part_uses_the_head_dims_table():
    """The rope part takes the first dr / 2 frequencies of the table built
    for the head dim: a table built for dr alone rotates by other angles,
    and the reference agrees with the port only on the head dim's."""
    cfg, tcfg = _cfgs()
    p, tp = _weights(cfg, seed=10)
    pos = np.arange(24, dtype=np.int32)
    x = _x(1, 24, cfg.d_model, 11)
    want = _run(cfg, tcfg, p, tp, x, pos)[0]
    wrong = tlayers.rope_angles(torch.from_numpy(pos),
                                tcfg.mla.qk_rope_head_dim, tcfg.rope_theta)
    other, _ = tattn.mla_attention(tp, torch.from_numpy(x), tcfg,
                                   angles=wrong, q_pos=torch.from_numpy(pos))
    assert np.abs(other.numpy() - np.asarray(want)).max() > 100 * TOL
