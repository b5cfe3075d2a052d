"""Pod-scale FedaGrac training (``repro.launch.train`` counterpart): the LM
round on a ``torch.distributed`` ``DeviceMesh``.

``build_train_round`` returns ``(round_fn, bundle)``: the FedaGrac round
with the client axis over the mesh's data axes (one client a data slice)
and tensor parallelism over ``model``.  ``round_fn(state, batches,
k_steps, weights, lam=None)`` places its inputs by the bundle's specs (a
whole tensor, the same on every rank, is cut to this rank's shard; a
DTensor is redistributed if it lies otherwise) and returns the new state
as DTensors placed by ``bundle["pspecs"]["state"]`` and the metrics as
DTensor scalars (``full_tensor()`` makes any of them whole).  With
``chunk_rounds > 1`` it returns the length-polymorphic chunk instead
(``core.engine.make_round_chunk(round_fn, None, donate=True)``): every
input stacked per round, ``lam`` a sequence of host floats, a shorter
tail chunk run by the same function, the state dict it is given handed
over (emptied, as the reference's chunk donates its carry).

Design (the reference's ``jit`` with shardings has no torch counterpart):

* The round's values are DTensors, placed at the reference's sites by the
  round's ``param_constraint`` (``MeshConstraint`` /
  ``FlatMeshConstraint``, a ``core.stages.NoMesh``): core/ knows of no
  mesh, only of that object's hooks.
* The local steps run in an explicit region (the constraint's
  ``local_steps``, on ``dist.ClientRegion``): each rank takes its data
  slice's clients as local rows and runs the round's own local steps on
  them, plain tensors where the model axes have one rank, the model's
  leaves as DTensors on the model sub-mesh where they have several (the
  model then runs tensor-parallel, B6/B7 on each rank's heads:
  models/attention.py ``_flash_sharded``).  The flat layout's rows stay
  this rank's shard of the flat axis in the region, so B1/B2 run on plain
  tensors; on several model ranks its gradient cuts the leaves from the
  rows leaf by leaf (``FlatMeshConstraint``).  So a ``(1, 1)`` mesh runs
  the local steps with no DTensor dispatch, and on a model mesh no rank
  holds a client's whole row: it holds its shard of each leaf (a
  ``_region_spec`` leaf whole), and one whole leaf at a time while the
  leaves are cut and the gradient written.
* Aggregation over the client dim is the constraint's ``rows_dot``: each
  rank sums its own rows and the partial sums are all-reduced over the
  data axes in float32; the ν⁽ⁱ⁾ store's rows are read and written per
  rank (``take_rows`` / ``put_rows``).

On a mesh of several ranks the dense family without a front end, MoE,
MLA or window layers is trained (llama3-8b, gemma-2b, qwen1.5-32b); the
other families are refused there (ROADMAP A15).  A mesh of one rank takes
every family the port trains.

``lower_train`` / ``lower_population`` are the counterpart of the
reference's ``.lower()`` on shape stand-ins: the step runs once on
``FakeTensorMode`` tensors over the given mesh (a fake process group in
the dry run, launch/dryrun.py) and returns ``(trace, bundle)``, the trace
holding the FLOPs a rank does, the bytes its ops move, the collectives by
kind with their bytes, the per-rank bytes of the step's inputs and
outputs and the rank's peak of live bytes (``roofline.analysis``).

``main`` runs a few real rounds on however many ranks the process group
has (one, with no group).  Its data are the port's own draws: token
streams from numpy seeds (``data.synthetic.lm_sequences``) and K_i from a
numpy Poisson(3) + 1 clipped to ``k_max``; the reference draws with
``jax.random.poisson``, which ``fed/keyed.py`` does not reproduce.  Parity
with the reference is held on fixed inputs through ``build_train_round``
instead (tests/test_torch_launch_train.py).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --rounds 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --param-layout flat --master-dtype float32 --chunk-rounds 2
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Any

import torch

from repro_torch import dist
from repro_torch.configs.base import FedConfig, ModelConfig, ShapeConfig
from repro_torch.core import engine, rounds, stages
from repro_torch.core.fedopt import get_algorithm
from repro_torch.core.tree_util import tree_map
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import data_axes, mesh_rules
from repro_torch.launch.serve import place, sharded_family
from repro_torch.models.model import lm_loss

PyTree = Any


def _check_scope(cfg: ModelConfig, mesh) -> None:
    ranks = math.prod(dist.view(mesh).shape.values())
    if ranks > 1 and not sharded_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training on a mesh of {ranks} ranks covers the "
            f"dense family without a front end (llama3-8b, gemma-2b, "
            f"qwen1.5-32b); the {cfg.family} family's sharded execution is "
            f"ROADMAP A15")


def _placed(x, spec, mesh):
    pl = dist.placements(spec, mesh)
    if dist.is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return dist.distribute(x, mesh, pl)


def _region_spec(mesh):
    """A leaf's spec over the model axes inside the local steps' region:
    the name-aware table's, except for two kinds of leaf that stay whole
    there.  Between the model's ``constrain`` sites (which act under
    ``torch.func.vmap`` through ``dist.on_physical``) DTensor's own
    propagation places the activations:

    * a vector (a norm's scale, a bias) sharded over its width would shard
      the normed activations' width, and every projection after it would
      then gather its weight; whole, the activations stay whole and each
      projection runs on its shard of heads or hidden units;
    * a vocab-sharded embedding lookup is DTensor's masked partial, whose
      mask was lost under vmap's batching of ``F.embedding``."""
    msize = specs_lib._msize(mesh)

    def region_spec(path, shape):
        logical = len(shape) - specs_lib._stack_dims(path)
        if logical <= 1 or specs_lib._leaf_name(path) == "embed":
            return specs_lib.P(*(None,) * len(shape))
        return specs_lib.param_pspec(path, shape, msize)
    return region_spec


class MeshConstraint(stages.NoMesh):
    """The tree layout's ``param_constraint`` on ``mesh``: every leaf
    placed by the name-aware table (``specs.tree_pspecs``), a client dim
    over the data axes where ``client_dims`` is 1.  Its hooks
    (``stages.NoMesh``): the local steps run in ``dist.ClientRegion``,
    each leaf placed there on the model sub-mesh by ``_region_spec`` (or
    plain where that has one rank); the client-dim sums and the ν⁽ⁱ⁾
    store's row reads and writes are ``dist``'s (``rows_dot``,
    ``take_rows``, ``put_rows``)."""

    rows_dot = staticmethod(dist.rows_dot)
    take_rows = staticmethod(dist.take_rows)
    put_rows = staticmethod(dist.put_rows)

    def __init__(self, mesh):
        self.mesh = mesh
        self.msize = specs_lib._msize(mesh)
        self.client_axes = data_axes(mesh)
        self.sub = dist.model_submesh(mesh, self.client_axes)
        self.region_spec = _region_spec(mesh)

    def __call__(self, tree: PyTree, client_dims: int) -> PyTree:
        ps = specs_lib.tree_pspecs(
            tree, self.msize,
            client_axes=self.client_axes if client_dims else ())
        flat_ps = dict(specs_lib.leaves_with_path(ps))
        return specs_lib.map_with_path(
            lambda p, x: _placed(x, flat_ps[p], self.mesh), tree)

    def _region(self, m: int):
        return dist.ClientRegion(self.mesh, self.client_axes, m)

    def local_steps(self, client_update):
        def run(anchor, c_all, batches, k_steps, lam):
            region = self._region(k_steps.shape[0])

            def leaf(t, path, lead):
                if not dist.is_dtensor(t):
                    return t
                return t.redistribute(self.sub, dist.placements(
                    (None,) * lead + tuple(self.region_spec(
                        path, tuple(t.shape[lead:]))), self.sub))
            out = client_update(
                specs_lib.map_with_path(
                    lambda p, t: leaf(region.whole(t), p, 0), anchor),
                specs_lib.map_with_path(
                    lambda p, t: leaf(region.down(t), p, 1), c_all),
                {k: region.down(v) for k, v in batches.items()},
                region.down(k_steps), lam)
            return tuple(None if t is None else tree_map(region.up, t)
                         for t in out)
        return run


class FlatMeshConstraint(MeshConstraint):
    """The flat layout's ``param_constraint`` on ``mesh``: ONE rule for
    every ``(…, P)`` buffer (``specs.flat_param_pspec``).  In the local
    steps' region each rank holds its clients' shard of the rows, a plain
    ``(m_local, P / model ranks)`` tensor (zero columns pad it to whole
    128-lane rows where it is not), and B1/B2 run on it.  Where the model
    axes have several ranks, the gradient (``flat_value_and_grad``) cuts
    the leaves from the rows leaf by leaf: each leaf's span of the flat
    axis is gathered over the model sub-mesh, this rank's shard of it kept
    (placed by ``_region_spec``) and the rest dropped, and each leaf
    gradient is gathered whole and this rank's part of the span copied
    into the gradient rows.  A rank thus holds its shard of every leaf,
    one whole leaf at a time, and never a whole row."""

    def __init__(self, mesh, p: int):
        super().__init__(mesh)
        self.p = p
        self.row_pl = dist.placements(
            specs_lib.flat_param_pspec(mesh, p, 1), mesh)
        self.vec_pl = dist.placements(
            specs_lib.flat_param_pspec(mesh, p, 0), mesh)

    def __call__(self, arr, client_dims: int):
        return _placed(arr, specs_lib.flat_param_pspec(self.mesh, self.p,
                                                       client_dims),
                       self.mesh)

    def _local(self, t, pl):
        return (t if tuple(t.placements) == pl
                else t.redistribute(self.mesh, pl)).to_local()

    def local_steps(self, client_update):
        from repro_torch.kernels.calibrated_update.ops import LANES

        def run(anchor, c_all, batches, k_steps, lam):
            region = self._region(k_steps.shape[0])
            a = self._local(anchor, self.vec_pl)
            width = a.shape[0]
            pad = -width % LANES

            def padded(t):
                return torch.nn.functional.pad(t, (0, pad)) if pad else t

            def up(t):
                if t is None:
                    return None
                t = t[:, :width].contiguous() if pad else t
                return dist.as_dtensor(t, self.mesh, self.row_pl,
                                       (region.m, self.p))
            x, g0, acc, loss0 = client_update(
                padded(a),
                None if c_all is None else padded(
                    self._local(c_all, self.row_pl)),
                {k: region.down(v) for k, v in batches.items()},
                region.down(k_steps), lam)
            return up(x), up(g0), up(acc), region.up(loss0)
        return run

    def flat_value_and_grad(self, spec, loss_fn):
        if self.sub is None:
            return None
        return _leafwise_value_and_grad(spec, loss_fn, self.mesh, self.sub,
                                        self.row_pl, self.region_spec)


def _leafwise_value_and_grad(spec, loss_fn, mesh, sub, row_pl, region_spec):
    """``vag(rows, batch)`` on this rank's ``(m, ≥ width)`` shard of its
    clients' flat rows, the leaves tensor-parallel on ``sub`` (the model
    sub-mesh); see ``FlatMeshConstraint``."""
    from torch.distributed.tensor import Shard

    from repro_torch.core import flat as flat_lib
    batched = torch.func.vmap(loss_fn)
    lo, width = dist.local_offset(mesh, row_pl, (1, spec.p), 1)
    split = width < spec.p
    n_sub = math.prod(sub.shape)
    gather_pl = (Shard(1),) * sub.ndim
    leaf_pl = [dist.placements((None,) + tuple(region_spec(path, shape)),
                               sub)
               for path, shape in zip(spec.paths, spec.shapes)]

    def mine(off, size):
        return max(off, lo), min(off + size, lo + width)

    def span(rows, off, size):
        """(m, size): the leaf's span of the rows, gathered over ``sub``
        (the flat axis splits over it in rank order)."""
        if not split:
            return rows.narrow(1, off, size)
        m = rows.shape[0]
        lens = [max(0, min(off + size, (r + 1) * width) - max(off, r * width))
                for r in range(n_sub)]
        a, b = mine(off, size)
        piece = rows.new_zeros((m, max(lens)))
        if b > a:
            piece[:, :b - a] = rows[:, a - lo:b - lo]
        got = dist.as_dtensor(piece, sub, gather_pl,
                              (m, n_sub * max(lens))).full_tensor()
        got = got.view(m, n_sub, max(lens))
        return torch.cat([got[:, r, :n] for r, n in enumerate(lens) if n],
                         dim=1)

    def run(rows, batch):
        m = rows.shape[0]
        leaves = []
        for off, size, shape, dtype, pl in zip(
                spec.offsets, spec.sizes, spec.shapes, spec.dtypes, leaf_pl):
            lv = span(rows, off, size).view((m,) + shape).to(dtype)
            local = dist.shard_of(lv, sub, pl).contiguous()
            leaves.append(dist.as_dtensor(local, sub, pl, (m,) + shape
                                          ).requires_grad_())
        with torch.enable_grad():
            losses = batched(flat_lib._tree(spec.treedef, leaves), batch)
            grads = list(torch.autograd.grad(losses.sum(), leaves))
        del leaves
        g = rows.new_zeros(rows.shape, dtype=spec.dtype)
        for i, (off, size) in enumerate(zip(spec.offsets, spec.sizes)):
            whole = grads[i].full_tensor().reshape(m, size)
            grads[i] = None
            a, b = mine(off, size)
            if b > a:
                g[:, a - lo:b - lo] = whole[:, a - off:b - off]
        return losses.full_tensor().detach(), g

    return run


def make_param_constraint(mesh) -> MeshConstraint:
    """The tree layout's ``param_constraint`` (``MeshConstraint``)."""
    return MeshConstraint(mesh)


def make_flat_param_constraint(mesh, p: int) -> FlatMeshConstraint:
    """Flat twin of ``make_param_constraint`` (``FlatMeshConstraint``)."""
    return FlatMeshConstraint(mesh, p)


@contextlib.contextmanager
def _on_mesh(mesh, rules):
    """The rules installed; plain tensors (K_i, weights, masks) taken as
    replicated where they meet DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    with dist.use_mesh(mesh, rules), implicit_replication(), \
            warnings.catch_warnings():
        # a (1,) vector (one client's weights) taken as replicated is
        # what is meant here
        warnings.filterwarnings("ignore", message="Found a non-scalar "
                                "tensor with numel=1")
        yield


def _to_mesh_device(t, mesh):
    t = torch.as_tensor(t)
    device = torch.device(mesh.device_type)
    return t if t.device.type == device.type else t.to(device)


def build_train_round(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      fed: FedConfig, *, k_max: int = 4,
                      chunk_rounds: int = 1):
    """Returns ``(round_fn, bundle)`` (see the module docstring).

    ``fed.param_layout="flat"`` builds the single-buffer round
    (core/flat.py): state is ``(P,)`` / ``(M, P)`` buffers (the bundle
    carries ``flat_spec``), the model consumes view-table slices of the
    buffer, and ``fed.master_dtype`` keeps a float32 master over bfloat16
    compute.  ``chunk_rounds > 1`` returns ``chunk(state, batches,
    k_steps, weights, lam)`` with every input stacked per round (leading
    ``(R,)``), for any R."""
    algo = get_algorithm(fed.algorithm, fed)
    rules = mesh_rules(mesh, kind="train")
    dist.set_mesh_rules(mesh, rules)
    _check_scope(cfg, mesh)

    def loss_fn(p, b):
        return lm_loss(p, b, cfg)

    if fed.param_layout == "flat":
        from repro_torch.core import flat as flat_lib
        bundle = specs_lib.flat_train_specs(
            cfg, shape, mesh, algo, k_max=k_max,
            master_dtype=fed.master_dtype or None)
        fspec = bundle["flat_spec"]
        inner = flat_lib.make_flat_round(
            fspec, loss_fn, algo, lr=fed.lr, k_max=k_max,
            param_constraint=make_flat_param_constraint(mesh, fspec.p))
    else:
        inner = rounds.make_round(loss_fn, algo, lr=fed.lr, k_max=k_max,
                                  param_constraint=make_param_constraint(
                                      mesh))
        bundle = specs_lib.train_specs(cfg, shape, mesh, algo, k_max=k_max)
    ps = bundle["pspecs"]

    def round_fn(state, batches, k_steps, weights, lam=None):
        state = place(state, ps["state"], mesh)
        batches = place(batches, ps["batches"], mesh)
        with _on_mesh(mesh, rules):
            return inner(state, batches, _to_mesh_device(k_steps, mesh),
                         _to_mesh_device(weights, mesh), lam)

    if chunk_rounds > 1:
        # the state is handed over, as the reference's chunk donates it:
        # the state from before the chunk is freed once round 1 has
        # replaced it
        return engine.make_round_chunk(round_fn, None, donate=True), bundle
    return round_fn, bundle


def build_population_round(cfg: ModelConfig, shape: ShapeConfig, mesh,
                           fed: FedConfig, *, m_population: int,
                           k_max: int = 4):
    """The cohort round at population scale on the tree layout: the
    mesh's data slots host a cohort of C = ``n_clients(mesh)`` sampled
    clients, and ν⁽ⁱ⁾ keeps ``m_population`` rows, row-sharded over the
    data axes.  Returns ``(round_fn, bundle)`` with ``round_fn(state,
    batches, cohort, k_steps, cweights)``; λ is ``algo.lam``.  The cohort's
    gather from and scatter into the row-sharded store are DTensor's
    collectives between the cohort layout and the store's."""
    algo = get_algorithm(fed.algorithm, fed)
    rules = mesh_rules(mesh, kind="train")
    dist.set_mesh_rules(mesh, rules)
    _check_scope(cfg, mesh)

    def loss_fn(p, b):
        return lm_loss(p, b, cfg)

    inner = stages.make_cohort_round(
        loss_fn, algo, lr=fed.lr, k_max=k_max, nu_decay=fed.cohort_nu_decay,
        param_constraint=make_param_constraint(mesh))
    bundle = specs_lib.population_train_specs(cfg, shape, mesh, algo,
                                              m_population, k_max=k_max)
    ps = bundle["pspecs"]

    def round_fn(state, batches, cohort, k_steps, cweights):
        state = place(state, ps["state"], mesh)
        batches = place(batches, ps["batches"], mesh)
        with _on_mesh(mesh, rules):
            return inner(state, batches,
                         _to_mesh_device(cohort, mesh).long(),
                         _to_mesh_device(k_steps, mesh),
                         _to_mesh_device(cweights, mesh))

    return round_fn, bundle


def lower_train(cfg: ModelConfig, shape: ShapeConfig, mesh, fed: FedConfig,
                *, k_max: int = 4):
    """One round on fake tensors over ``mesh``: ``(trace, bundle)``."""
    from repro_torch.roofline import analysis
    step, bundle = build_train_round(cfg, shape, mesh, fed, k_max=k_max)
    s = bundle["specs"]
    trace = analysis.trace_step(
        step, (s["state"], s["batches"], s["k_steps"], s["weights"]),
        (bundle["pspecs"]["state"], bundle["pspecs"]["batches"], None, None),
        mesh)
    return trace, bundle


def lower_population(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     fed: FedConfig, *, m_population: int, k_max: int = 4):
    """One cohort round on fake tensors over ``mesh``: ``(trace,
    bundle)``."""
    from repro_torch.roofline import analysis
    step, bundle = build_population_round(
        cfg, shape, mesh, fed, m_population=m_population, k_max=k_max)
    s, ps = bundle["specs"], bundle["pspecs"]
    trace = analysis.trace_step(
        step, (s["state"], s["batches"], s["cohort"], s["k_steps"],
               s["cweights"]),
        (ps["state"], ps["batches"], None, None, None), mesh)
    return trace, bundle


# ---------------------------------------------------------------------------
# real-execution driver
# ---------------------------------------------------------------------------

def _fit_mesh(device_type: str = "cuda"):
    """The production mesh when the world has 256 / 512 ranks; else the
    largest ``(data, model)`` grid over this world's ranks (one process:
    ``1 × 1``)."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    n = tdist.get_world_size() if tdist.is_initialized() else 1
    if n >= 512:
        return make_production_mesh(multi_pod=True, device_type=device_type)
    if n >= 256:
        return make_production_mesh(device_type=device_type)
    data = 1
    while data * 2 <= n and data < 16:
        data *= 2
    return make_local_mesh(data, max(n // data, 1), device_type=device_type)


def round_inputs(cfg: ModelConfig, m: int, k_max: int, b_local: int,
                 seq_len: int, t: int) -> tuple[dict, torch.Tensor]:
    """Round ``t``'s batches ``(m, k_max, b_local, seq_len)`` and K_i, the
    port's own draws (module docstring)."""
    import numpy as np
    from repro_torch.data.synthetic import lm_sequences
    data = lm_sequences(t, m * k_max * b_local, seq_len, cfg.vocab)
    batches = {k: v.reshape(m, k_max, b_local, -1) for k, v in data.items()}
    rng = np.random.default_rng((1, 1000 + t))
    ks = np.clip(rng.poisson(3, m) + 1, 1, k_max).astype(np.int32)
    return batches, torch.from_numpy(ks)


def main(argv=None) -> None:
    import argparse
    import dataclasses

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.distributed import bootstrap, is_coordinator
    from repro_torch.launch.mesh import n_clients
    from repro_torch.models.model import init_params

    ap = argparse.ArgumentParser(description="FedaGrac pod training")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3-8b")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--k-max", type=int, default=4)
    ap.add_argument("--chunk-rounds", type=int, default=1,
                    help="rounds per chunk (core/engine.py; the host reads "
                         "the metrics once a chunk)")
    ap.add_argument("--algo", default="fedagrac")
    ap.add_argument("--param-layout", choices=("tree", "flat"),
                    default="tree",
                    help="flat = single-buffer rounds with the view-table "
                         "loss boundary (core/flat.py)")
    ap.add_argument("--master-dtype", choices=("", "float32"), default="",
                    help="flat-only: master-buffer dtype override "
                         "(float32 master over bfloat16 compute)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced model + tiny shape (CPU/dev runs)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (the card unless cpu)")
    args = ap.parse_args(argv)

    bootstrap()
    mesh = _fit_mesh(args.device)
    cfg = get_arch(args.arch)
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg = reduced(cfg)
        shape = dataclasses.replace(shape, seq_len=128,
                                    global_batch=2 * n_clients(mesh))
    cfg = specs_lib.bf16_config(cfg) if not args.reduced else cfg
    fed = FedConfig(algorithm=args.algo, lr=0.3 if args.reduced else 3e-2,
                    param_layout=args.param_layout,
                    master_dtype=args.master_dtype)
    chunk = max(args.chunk_rounds, 1)
    step, bundle = build_train_round(cfg, shape, mesh, fed,
                                     k_max=args.k_max, chunk_rounds=chunk)
    m, b_local = bundle["m"], bundle["b_local"]
    algo = get_algorithm(fed.algorithm, fed)
    device = torch.device(args.device)
    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    if args.param_layout == "flat":
        from repro_torch.core import flat as flat_lib
        params = flat_lib.ravel(bundle["flat_spec"], params)
    state = rounds.init_state(params, m, algo)
    del params
    state = place(state, bundle["pspecs"]["state"], mesh)
    weights = torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)

    def inputs(t):
        batches, ks = round_inputs(cfg, m, args.k_max, b_local,
                                   shape.seq_len, t)
        return ({k: v.to(device) for k, v in batches.items()},
                ks.to(device))

    for t0 in range(0, args.rounds, chunk):
        r = min(chunk, args.rounds - t0)          # the tail chunk may be short
        if chunk == 1:
            batches, ks = inputs(t0)
            state, metrics = step(state, batches, ks, weights)
            losses = [float(_whole(metrics["loss"]))]
            kbars = [float(_whole(metrics["kbar"]))]
        else:
            per_round = [inputs(t0 + j) for j in range(r)]
            batches = {k: torch.stack([b[k] for b, _ in per_round])
                       for k in per_round[0][0]}
            ks = torch.stack([k for _, k in per_round])
            state, metrics = step(state, batches, ks,
                                  weights.expand(r, m), [algo.lam] * r)
            losses = _whole(metrics["loss"]).tolist()
            kbars = _whole(metrics["kbar"]).tolist()
        if is_coordinator():
            for j, (lo, kb) in enumerate(zip(losses, kbars)):
                print(f"round {t0 + j + 1}/{args.rounds}  "
                      f"loss {lo:.4f}  kbar {kb:.2f}", flush=True)


def _whole(t):
    return t.full_tensor() if dist.is_dtensor(t) else t


if __name__ == "__main__":
    main()
