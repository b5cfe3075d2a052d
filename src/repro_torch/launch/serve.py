"""Sharded serving steps (``repro.launch.serve`` counterpart): prefill
(prompt → KV caches + last logits) and decode (one token against a
``seq_len`` cache, optionally sequence-sharded for long contexts), on a
``torch.distributed`` ``DeviceMesh``.

``build_prefill``, ``build_decode`` and ``build_personalized_decode``
each install the mesh's rules (``launch.mesh.mesh_rules``), build
``specs.serve_specs`` and return ``(step, bundle)``.  ``step`` places its
inputs by the bundle's specs (a whole tensor, the same on every rank, is
cut to this rank's shard; a DTensor is redistributed if it lies
otherwise), runs the port's ``serve_prefill`` / ``serve_decode`` on them
as DTensors under the rules (``dist.constrain`` at the reference's sites;
B6, the flash kernel, on each rank's heads and rows), and returns the
logits as a DTensor (``full_tensor()`` makes them whole) and the caches
placed by ``bundle["cache_ps"]``.  A prefill or decode step consumes its
caches: the new ones are written into their buffers (``donate``), so a
step holds one cache (a 32 B model's weights and a second cache do not
fit on one card).  ``place``
puts a whole tree on the mesh once, so a step finds it placed.

Sharded execution on a mesh of more than one rank covers the dense family
without a front end (llama3-8b, gemma-2b, qwen1.5-32b); the three refuse
the other families there (ROADMAP A15).  A mesh of one rank takes every
arch the port serves.

``lower_serve`` and ``lower_personalized_serve`` stand where the
reference's return an XLA ``Lowered``, which has no torch counterpart:
each runs its step once on ``FakeTensorMode`` tensors over the mesh it is
given (a fake process group in the dry run, launch/dryrun.py) and returns
``(trace, bundle)``, the trace holding the FLOPs a rank does, the bytes
its ops move, the collectives by kind with their bytes, the per-rank
bytes of the step's inputs and outputs and the rank's peak of live bytes
(``roofline.analysis.trace_step``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch

from repro_torch import dist
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import mesh_rules
from repro_torch.models.model import serve_decode, serve_prefill

PyTree = Any


def sharded_family(cfg: ModelConfig) -> bool:
    """The archs whose serving runs sharded on a mesh of several ranks:
    dense attention stacks with no front end, MoE, MLA or window."""
    return (cfg.family == "dense" and cfg.frontend == "none"
            and cfg.moe is None and cfg.mla is None
            and not cfg.sliding_window)


def _check_scope(cfg: ModelConfig, mesh) -> None:
    ranks = math.prod(dist.view(mesh).shape.values())
    if ranks > 1 and not sharded_family(cfg):
        raise NotImplementedError(
            f"{cfg.name}: serving on a mesh of {ranks} ranks covers the "
            f"dense family without a front end (llama3-8b, gemma-2b, "
            f"qwen1.5-32b); the {cfg.family} family's sharded execution is "
            f"ROADMAP A15")


def place(tree: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """``tree`` on ``mesh`` by ``pspecs``: a whole tensor (the same on every
    rank) becomes this rank's shard on the mesh's device type, without a
    copy where the spec replicates it and it is there already; a DTensor is
    redistributed where its placements differ."""
    device = torch.device(mesh.device_type)

    def one(path, t):
        pl = dist.placements(_spec_at(pspecs, path), mesh)
        if dist.is_dtensor(t):
            return t if tuple(t.placements) == pl else t.redistribute(
                mesh, pl)
        t = torch.as_tensor(t)
        return dist.distribute(
            t, mesh, pl, device=None if t.device.type == device.type
            else device)
    return specs_lib.map_with_path(one, tree)


def _spec_at(pspecs: PyTree, path: tuple):
    for key in path:
        pspecs = pspecs[key]
    return pspecs


@contextlib.contextmanager
def _sharded(mesh, rules):
    """The rules installed, plain tensors taken as replicated where they
    meet DTensors (positions, rope angles, masks), no autograd."""
    from torch.distributed.tensor.experimental import implicit_replication
    with dist.use_mesh(mesh, rules), implicit_replication(), \
            torch.no_grad():
        yield


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh):
    rules = mesh_rules(mesh, kind="prefill")
    dist.set_mesh_rules(mesh, rules)
    _check_scope(cfg, mesh)
    bundle = specs_lib.serve_specs(cfg, shape, mesh, kind="prefill")

    def step(params, batch, caches):
        params = place(params, bundle["param_ps"], mesh)
        batch = place(batch, bundle["batch_ps"], mesh)
        caches = place(caches, bundle["cache_ps"], mesh)
        with _sharded(mesh, rules):
            logits, caches = serve_prefill(params, batch, cfg,
                                           caches=caches, donate=True)
        return logits, place(caches, bundle["cache_ps"], mesh)

    return step, bundle


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 kind: str = "decode"):
    """kind "decode" (batch over data) or "long" (cache sequence over
    data)."""
    rules = mesh_rules(mesh, kind=kind)
    dist.set_mesh_rules(mesh, rules)
    _check_scope(cfg, mesh)
    bundle = specs_lib.serve_specs(cfg, shape, mesh, kind=kind)
    seq_shard = kind == "long"

    def step(params, batch, caches, pos_offset):
        params = place(params, bundle["param_ps"], mesh)
        batch = place(batch, bundle["batch_ps"], mesh)
        caches = place(caches, bundle["cache_ps"], mesh)
        with _sharded(mesh, rules):
            logits, caches = serve_decode(params, batch, caches, pos_offset,
                                          cfg, seq_shard=seq_shard,
                                          donate=True)
        return logits, place(caches, bundle["cache_ps"], mesh)

    return step, bundle


def build_personalized_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                              spec):
    """Personalized decode tick on a mesh (serving/personalized.py): the
    ``(P,)`` flat base shards over the model axes by ``flat_param_pspec``
    (the flat training state's rule), the per-slot ``(B, P)`` delta rows
    also shard their batch dim over the data axes, and each slot's row
    (base + delta) feeds the vmapped view-table decode.

    The view table cuts each row into leaves at fixed offsets, which a
    flat axis sharded over the model axes does not follow, so the decode
    is an explicit region: the rows are all-gathered over the model axes
    (each rank keeps its data shard's slots), the caches likewise, and
    each rank runs ``personalized_decode`` on its slots; the logits come
    back sharded over the data axes, the caches placed by
    ``bundle["cache_ps"]``."""
    from repro_torch.serving.personalized import personalized_decode

    rules = mesh_rules(mesh, kind="decode")
    dist.set_mesh_rules(mesh, rules)
    _check_scope(cfg, mesh)
    bundle = specs_lib.serve_specs(cfg, shape, mesh, kind="decode")
    b = shape.global_batch
    bundle["base"] = specs_lib._sds((spec.p,), spec.dtype)
    bundle["base_ps"] = specs_lib.flat_param_pspec(mesh, spec.p)
    bundle["deltas"] = specs_lib._sds((b, spec.p), spec.dtype)
    bundle["delta_ps"] = specs_lib.flat_param_pspec(mesh, spec.p,
                                                    client_dims=1)
    lead = bundle["batch_ps"]["tokens"][0]
    row_pl = dist.placements(specs_lib.P(lead, None), mesh)
    # every cache leaf's batch dim is its third (n_groups, count, B, …)
    cache_pl = dist.placements(specs_lib.P(None, None, lead), mesh)

    def step(base, deltas, batch, caches, pos_offset):
        base = place(base, bundle["base_ps"], mesh)
        deltas = place(deltas, bundle["delta_ps"], mesh)
        batch = place(batch, bundle["batch_ps"], mesh)
        caches = place(caches, bundle["cache_ps"], mesh)
        with _sharded(mesh, rules):
            rows = base[None] + deltas
            rows = rows.redistribute(mesh, row_pl).to_local()
        tokens = batch["tokens"].to_local()
        local = specs_lib.map_with_path(
            lambda _p, c: c.redistribute(mesh, cache_pl).to_local(), caches)
        offsets = dist.shard_of(torch.as_tensor(
            pos_offset, device=rows.device).expand(b), mesh, row_pl)
        with torch.no_grad():
            logits, local = personalized_decode(spec, cfg, rows, tokens,
                                                local, offsets)
        logits = dist.as_dtensor(logits, mesh, row_pl,
                                 (b,) + tuple(logits.shape[1:]))
        out = specs_lib.map_with_path(
            lambda p, c: dist.as_dtensor(c, mesh, cache_pl,
                                         _spec_at(caches, p).shape), local)
        return logits, place(out, bundle["cache_ps"], mesh)

    return step, bundle


def lower_serve(cfg: ModelConfig, shape: ShapeConfig, mesh, *, kind: str):
    """One prefill, decode or long-decode step on fake tensors over
    ``mesh``: ``(trace, bundle)``.  A decode step writes the cache's last
    slot (position ``seq_len − 1``)."""
    from repro_torch.roofline import analysis
    if kind == "prefill":
        step, bundle = build_prefill(cfg, shape, mesh)
    else:
        step, bundle = build_decode(cfg, shape, mesh, kind=kind)
        decode = step

        def step(params, batch, caches):
            return decode(params, batch, caches, shape.seq_len - 1)
    trace = analysis.trace_step(
        step, (bundle["params"], bundle["batch"], bundle["caches"]),
        (bundle["param_ps"], bundle["batch_ps"], bundle["cache_ps"]), mesh)
    return trace, bundle


def lower_personalized_serve(cfg: ModelConfig, shape: ShapeConfig, mesh,
                             spec):
    """One personalized decode tick on fake tensors over ``mesh``:
    ``(trace, bundle)``."""
    from repro_torch.roofline import analysis
    step, bundle = build_personalized_decode(cfg, shape, mesh, spec)

    def tick(base, deltas, batch, caches):
        return step(base, deltas, batch, caches, shape.seq_len - 1)
    trace = analysis.trace_step(
        tick, (bundle["base"], bundle["deltas"], bundle["batch"],
               bundle["caches"]),
        (bundle["base_ps"], bundle["delta_ps"], bundle["batch_ps"],
         bundle["cache_ps"]), mesh)
    return trace, bundle
