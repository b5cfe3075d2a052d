"""The port's launch-layer specs (``repro_torch.launch.specs`` / ``mesh``,
``repro_torch.dist``) against the reference's, leaf by leaf by path: pure
shape logic on stand-in meshes of the production sizes, no ranks."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import dist as jdist  # noqa: E402
from repro.configs.base import FedConfig as JFedConfig  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.core.fedopt import get_algorithm as jget_algorithm  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import dist  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: E402
from repro_torch.core.fedopt import get_algorithm  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"tp16": FakeMesh({"data": 16, "model": 16}),
          "multi_pod": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "2d": FakeMesh({"data": 16, "batch": 4, "model": 4})}
KINDS = {"train_4k": "train", "prefill_32k": "prefill",
         "decode_32k": "decode", "long_500k": "long"}
ALGO = get_algorithm("fedagrac", FedConfig(algorithm="fedagrac"))
JALGO = jget_algorithm("fedagrac", JFedConfig(algorithm="fedagrac"))


def _key(k):
    if hasattr(k, "key"):
        return k.key
    return getattr(k, "idx", k)


def _jspecs(tree) -> dict:
    """path → tuple(PartitionSpec) over a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(_key(k) for k in path): tuple(ps) for path, ps in flat}


def _tspecs(tree) -> dict:
    return {path: tuple(ps) for path, ps in specs.leaves_with_path(tree)}


def _jshapes(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(k) for k in path): tuple(x.shape) for path, x in flat}


def _tshapes(tree) -> dict:
    return {path: tuple(x.shape) for path, x in specs.leaves_with_path(tree)}


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    bad = [(p, got[p], want[p]) for p in want if got[p] != want[p]]
    assert not bad, (what, len(bad), bad[:5])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference_every_shape_and_mesh(arch):
    """``serve_specs`` (params, batch, caches and their specs) for the
    three serving shapes and ``train_specs`` / ``population_train_specs``
    / ``flat_train_specs`` for train_4k, on the tp16, multi-pod and 2d
    production meshes: the same leaves, shapes and specs as the
    reference's."""
    jdist.unset_mesh()
    cfg = specs.bf16_config(get_arch(arch))
    jcfg = jspecs.bf16_config(JARCHS[arch])
    for mname, mesh in MESHES.items():
        for sname, kind in KINDS.items():
            shape, jshape = tshapes.SHAPES[sname], JSHAPES[sname]
            what = f"{arch} {mname} {sname}"
            if kind != "train":
                got = specs.serve_specs(cfg, shape, mesh, kind=kind)
                want = jspecs.serve_specs(jcfg, jshape, mesh, kind=kind)
                for key in ("param_ps", "batch_ps", "cache_ps"):
                    _same(_tspecs(got[key]), _jspecs(want[key]),
                          f"{what} {key}")
                for key in ("params", "batch", "caches"):
                    _same(_tshapes(got[key]), _jshapes(want[key]),
                          f"{what} {key}")
                continue
            for fn, kw in ((specs.train_specs, {}),
                           (specs.population_train_specs,
                            {"m_population": 4096}),
                           (specs.flat_train_specs, {})):
                jfn = getattr(jspecs, fn.__name__)
                got = fn(cfg, shape, mesh, ALGO, k_max=2, **kw)
                want = jfn(jcfg, jshape, mesh, JALGO, k_max=2, **kw)
                _same(_tspecs(got["pspecs"]), _jspecs(want["pspecs"]),
                      f"{what} {fn.__name__}")
                _same(_tshapes(got["specs"]), _jshapes(want["specs"]),
                      f"{what} {fn.__name__} shapes")
                assert got["m"] == want["m"] and \
                    got["b_local"] == want["b_local"]
                if fn is specs.flat_train_specs:
                    assert (got["flat_spec"].n, got["flat_spec"].p) == (
                        want["flat_spec"].n, want["flat_spec"].p)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_rules_and_clients_equal_reference(mesh):
    m = MESHES[mesh]
    for kind in ("train", "prefill", "decode", "long"):
        assert tmesh.mesh_rules(m, kind=kind) == jmesh.mesh_rules(
            m, kind=kind)
    assert tmesh.n_clients(m) == jmesh.n_clients(m)
    assert tmesh.data_axes(m) == jmesh.data_axes(m)
    assert tmesh.model_axes(m) == jmesh.model_axes(m)
    with pytest.raises(ValueError):
        tmesh.mesh_rules(m, kind="serve")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_recommended_variant_equals_reference(arch):
    assert tmesh.recommended_variant(get_arch(arch)) == \
        jmesh.recommended_variant(JARCHS[arch])


@pytest.mark.parametrize("variant,multi_pod,shape", [
    ("tp16", False, {"data": 16, "model": 16}),
    ("tp16", True, {"pod": 2, "data": 16, "model": 16}),
    ("2d", False, {"data": 16, "batch": 4, "model": 4}),
    ("2d", True, {"pod": 2, "data": 16, "batch": 4, "model": 4})])
def test_production_layouts(variant, multi_pod, shape):
    """The reference's production shapes and axis names, 256 or 512
    ranks (``make_production_mesh`` builds them as a ``DeviceMesh`` in a
    world of that size)."""
    dims, names = tmesh.production_layout(multi_pod=multi_pod,
                                          variant=variant)
    assert dict(zip(names, dims)) == shape
    assert math.prod(dims) == (512 if multi_pod else 256)
    with pytest.raises(ValueError):
        tmesh.production_layout(variant="3d")


def test_physical_drop_and_empty_rules():
    """A mesh axis that does not divide the dimension is dropped (the dim
    stays replicated), and a rule mapped to () replicates, as in the
    reference; the placements of a spec follow its axes, an axis of size
    1 replicating."""
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh({"data": 4, "model": 8})
    rules = {"dp": ("data",), "mp": ("model",), "sp": ()}
    for lib in (dist, jdist):
        lib.set_mesh_rules(m, rules)
    try:
        for name, d in (("mp", 40), ("mp", 12), ("dp", 6), ("dp", 8),
                        ("sp", 64), (None, 64), ("mp", 8)):
            assert dist._physical(name, d) == jdist._physical(name, d)
        assert dist._physical("mp", 12) is None
        assert dist._physical("sp", 64) is None
        assert dist.axis_size("mp") == jdist.axis_size("mp") == 8
    finally:
        dist.unset_mesh()
        jdist.unset_mesh()
    assert dist.placements(specs.P(None, "model", ("pod", "data")),
                           MESHES["multi_pod"]) == (Shard(2), Shard(2),
                                                    Shard(1))
    assert dist.placements(specs.P(None, None), m) == (Replicate(),) * 2
    # an axis of size 1 replicates: a one-rank mesh places nothing
    assert dist.placements(specs.P("data", "model"), FakeMesh(
        {"data": 1, "model": 2})) == (Replicate(), Shard(1))
    assert dist.placements(specs.P("data", "model"), FakeMesh(
        {"data": 1, "model": 1})) == (Replicate(), Replicate())
    two = specs.to_shardings({"a": [specs.P("data", None)]}, m)
    assert two == {"a": [(Shard(0), Replicate())]}


def test_abstract_params_no_allocation():
    """qwen1.5-32b's parameter tree on the meta device: no storage, and
    within 2% of ``param_count()``, as the reference's test holds it."""
    cfg = specs.bf16_config(get_arch("qwen1.5-32b"))
    leaves = [t for _, t in specs.leaves_with_path(
        specs.abstract_params(cfg))]
    assert all(t.is_meta for t in leaves)
    total = sum(t.numel() for t in leaves)
    assert abs(total - cfg.param_count()) / cfg.param_count() < 0.02
    assert {t.dtype for t in leaves} == {torch.bfloat16}


def test_shapes_equal_reference():
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in tshapes.SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in JSHAPES.items()}
    from repro.configs.shapes import LONG_CONTEXT_OK
    assert tshapes.LONG_CONTEXT_OK == LONG_CONTEXT_OK


def test_population_specs_refuse_as_reference():
    cfg = specs.bf16_config(get_arch("llama3-8b"))
    with pytest.raises(ValueError, match="smaller than"):
        specs.population_train_specs(cfg, tshapes.SHAPES["train_4k"],
                                     MESHES["tp16"], ALGO, m_population=8)
    with pytest.raises(ValueError, match="must divide"):
        specs.population_train_specs(cfg, tshapes.SHAPES["train_4k"],
                                     MESHES["tp16"], ALGO, m_population=20)
