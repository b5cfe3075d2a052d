"""Parameter / state / input sharding specs and shape stand-ins
(``repro.launch.specs`` counterpart).

* ``param_pspec``     name-aware tensor-parallel rules for every leaf of the
                      model zoo (embeddings / vocab, attention heads, ffn
                      hidden, MoE expert axis, SSM heads, …);
* ``abstract_params`` the parameter tree on the ``meta`` device (shapes and
                      dtypes, no allocation);
* ``train_specs``     the FedaGrac round state and (M, k_max, B, …) batches;
* ``serve_specs``     prefill / decode / long-decode inputs and KV caches.

A spec is the reference's ``PartitionSpec`` in plain form, a ``Spec``: a
tuple with one entry a dim, ``None``, a mesh axis name or a tuple of axis
names, so ``tuple(PartitionSpec)`` compares with it.  ``to_shardings``
turns specs into DTensor placements, one a mesh axis.  Stand-ins for
arrays are ``meta`` tensors.  Trees are the port's nested dicts and
lists; a leaf's path is its dict keys and list indices, and the rules read
the last dict key (``_leaf_name``) and whether ``"segments"`` (stacked
``(n_groups, count, …)`` layers) is on it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import dist
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import rounds
from repro_torch.core.fedopt import Algorithm
from repro_torch.launch.mesh import data_axes, model_axes, n_clients
from repro_torch.models import model as model_lib

PyTree = Any

# last-path-component → preferred shard dim of the *logical* tensor
# (negative = from the end).  Names not listed fall through to the generic
# rule.
_NAME_RULES: dict[str, int] = {
    # output projections: contract dim holds heads/ffn shards
    "wo": -2, "out_proj": -2, "down": -2, "ff_down": -2,
    # input projections: output dim holds heads/ffn shards
    "wq": -1, "wk": -1, "wv": -1, "w_kv_up": -1, "up": -1, "ff_up": -1,
    "in_proj": -1, "W": -1, "w_gates": -1,
    # embeddings / lm heads: shard the vocab axis
    "embed": -2, "head": -1, "heads": -1,
    # sLSTM block-diagonal recurrence: shard heads
    "R": -3,
}


class Spec(tuple):
    """One sharding entry a dim: ``None``, an axis name or a tuple of axis
    names (the reference's ``PartitionSpec``)."""


def P(*entries) -> Spec:
    return Spec(entries)


def map_with_path(fn, tree: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over a tree of dicts and lists (a ``Spec`` is a
    leaf); a path holds the dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree: PyTree) -> list[tuple[tuple, Any]]:
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _stack_dims(path) -> int:
    """Leading scan-stack dims: segments params carry (n_groups, count)."""
    return 2 if "segments" in path else 0


def _msize(mesh) -> int:
    shape = dist.view(mesh).shape
    out = 1
    for a in model_axes(mesh):
        out *= shape[a]
    return out


def _dsize(mesh) -> int:
    shape = dist.view(mesh).shape
    out = 1
    for a in data_axes(mesh):
        out *= shape[a]
    return out


def _axis_entry(axes: tuple):
    """A single physical axis enters a spec as its bare name, several as a
    tuple, none as ``None``."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def param_pspec(path, shape: tuple[int, ...], model_size: int) -> Spec:
    """Spec over the ``model`` mesh axis for one parameter leaf."""
    name = _leaf_name(path)
    stack = _stack_dims(path)
    logical = len(shape) - stack
    spec: list[Optional[str]] = [None] * len(shape)
    if model_size <= 1 or logical <= 0:
        return Spec(spec)

    def try_dim(d: int) -> bool:
        if -logical <= d < 0:
            d = len(shape) + d
        elif d < stack:
            return False
        if shape[d] % model_size == 0 and shape[d] >= model_size:
            spec[d] = "model"
            return True
        return False

    # MoE expert tensors: shard the expert axis first (expert parallelism)
    if name in ("w_in", "w_gate", "w_out") and logical == 3:
        if try_dim(-3) or try_dim(-1 if name != "w_out" else -2):
            return Spec(spec)
    if name in ("w_in", "w_gate"):
        if try_dim(-1):
            return Spec(spec)
    if name == "w_out":
        if try_dim(-2):
            return Spec(spec)
    rule = _NAME_RULES.get(name)
    if rule is not None and try_dim(rule):
        return Spec(spec)
    # generic fallback: largest logical dim that divides
    order = sorted(range(stack, len(shape)), key=lambda d: -shape[d])
    for d in order:
        if try_dim(d - len(shape)):
            return Spec(spec)
    return Spec(spec)


def _prepend(spec: Spec, axes) -> Spec:
    return Spec((_axis_entry(tuple(axes)),) + tuple(spec))


def tree_pspecs(tree: PyTree, model_size: int,
                client_axes: tuple[str, ...] = ()) -> PyTree:
    """Every leaf's spec (optionally client-stacked: a leading client dim
    over ``client_axes``)."""
    def one(path, leaf):
        shape = tuple(leaf.shape[1:] if client_axes else leaf.shape)
        ps = param_pspec(path, shape, model_size)
        return _prepend(ps, client_axes) if client_axes else ps
    return map_with_path(one, tree)


def to_shardings(pspecs: PyTree, mesh) -> PyTree:
    """Each spec's DTensor placements on ``mesh``, one a mesh axis (an
    axis of size 1 replicates)."""
    return map_with_path(lambda _p, ps: dist.placements(ps, mesh), pspecs)


# ---------------------------------------------------------------------------
# abstract params / state
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: ``init_params``
    on it builds the parameter tree's shapes and dtypes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig) -> PyTree:
    return model_lib.init_params(_MetaGenerator(), cfg)


def abstract_state(cfg: ModelConfig, algo: Algorithm, m: int) -> PyTree:
    return rounds.init_state(abstract_params(cfg), m, algo)


def state_pspecs(state: PyTree, mesh) -> PyTree:
    """Sharding for the round-engine state dict."""
    msize = _msize(mesh)
    cl = data_axes(mesh)
    out = {"params": tree_pspecs(state["params"], msize), "round": P()}
    if "nu" in state:
        out["nu"] = tree_pspecs(state["nu"], msize)
        out["nu_i"] = tree_pspecs(state["nu_i"], msize, client_axes=cl)
    return out


# ---------------------------------------------------------------------------
# batch stand-ins
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _client_batch(cfg: ModelConfig, b: int, s: int, *, labels: bool) -> dict:
    """Per-microbatch model inputs (no leading client/step dims)."""
    i32 = torch.int32
    if cfg.frontend == "audio":
        out = {"codes": _sds((b, cfg.n_codebooks, s), i32)}
        if labels:
            out["labels"] = _sds((b, cfg.n_codebooks, s), i32)
        return out
    if cfg.frontend == "vision":
        out = {"embeds": _sds((b, s, cfg.d_model), cfg.dtype),
               "positions": _sds((b, 3, s), i32)}
        if labels:
            out["labels"] = _sds((b, s), i32)
        return out
    out = {"tokens": _sds((b, s), i32)}
    if labels:
        out["labels"] = _sds((b, s), i32)
    return out


def _batch_pspecs(batches: PyTree, mesh) -> PyTree:
    """(M|C, k, B, …) batch sharding: the client dim over the data axes;
    the 2d mesh variant also shards the per-client microbatch dim over the
    "batch" axis."""
    cl = data_axes(mesh)
    v = dist.view(mesh)
    has_batch = "batch" in v.axis_names

    def _bspec(_path, x):
        spec = [_axis_entry(cl)] + [None] * (x.dim() - 1)
        if (has_batch and x.dim() >= 3
                and x.shape[2] % v.shape["batch"] == 0):
            spec[2] = "batch"
        return Spec(spec)

    return map_with_path(_bspec, batches)


def _round_batches(cfg: ModelConfig, shape: ShapeConfig, m: int,
                   k_max: int) -> tuple[int, dict]:
    assert shape.global_batch % m == 0, (shape.global_batch, m)
    b_local = shape.global_batch // m
    micro = _client_batch(cfg, b_local, shape.seq_len, labels=True)
    return b_local, {k: _sds((m, k_max) + tuple(x.shape), x.dtype)
                     for k, x in micro.items()}


def train_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, algo: Algorithm,
                k_max: int = 4) -> dict:
    """Round inputs: state, batches (M, k_max, B_local, …), k_steps,
    weights."""
    m = n_clients(mesh)
    b_local, batches = _round_batches(cfg, shape, m, k_max)
    state = abstract_state(cfg, algo, m)
    specs = {
        "state": state,
        "batches": batches,
        "k_steps": _sds((m,), torch.int32),
        "weights": _sds((m,), torch.float32),
    }
    pspecs = {
        "state": state_pspecs(state, mesh),
        "batches": _batch_pspecs(batches, mesh),
        "k_steps": P(),
        "weights": P(),
    }
    return {"specs": specs, "pspecs": pspecs, "m": m, "b_local": b_local}


def population_train_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                           algo: Algorithm, m_population: int,
                           k_max: int = 4) -> dict:
    """Cohort-round inputs at population scale: the mesh's data slots host
    the cohort (C = n_clients(mesh)); ``nu_i`` carries ``m_population``
    rows, row-sharded over the data axes, while batches, cohort, k and
    cweights are cohort-sized.  ``m_population`` must be a multiple of the
    data-parallel size."""
    m = n_clients(mesh)
    if m_population < m:
        raise ValueError(f"population {m_population} smaller than the "
                         f"mesh cohort {m}")
    dsize = _dsize(mesh)
    if dsize > 1 and m_population % dsize:
        raise ValueError(
            f"m_population={m_population} must divide over the data-"
            f"parallel size {dsize} for the ν⁽ⁱ⁾ row sharding")
    b_local, batches = _round_batches(cfg, shape, m, k_max)
    state = abstract_state(cfg, algo, m_population)
    specs = {
        "state": state,
        "batches": batches,
        "cohort": _sds((m,), torch.int32),
        "k_steps": _sds((m,), torch.int32),
        "cweights": _sds((m,), torch.float32),
    }
    pspecs = {
        "state": state_pspecs(state, mesh),
        "batches": _batch_pspecs(batches, mesh),
        "cohort": P(),
        "k_steps": P(),
        "cweights": P(),
    }
    return {"specs": specs, "pspecs": pspecs, "m": m,
            "m_population": m_population, "b_local": b_local}


# ---------------------------------------------------------------------------
# flat-layout round state (core/flat.py)
# ---------------------------------------------------------------------------

def _flat_axis(mesh, p: int):
    """The mesh axes the lane-padded flat parameter axis shards over: the
    model axes when they divide P, else replicated."""
    msize = _msize(mesh)
    if msize <= 1 or p % msize:
        return None
    return _axis_entry(model_axes(mesh))


def flat_param_pspec(mesh, p: int, client_dims: int = 0) -> Spec:
    """Spec of one ``(…, P)`` flat buffer: client rows over the data
    axes, the flat axis over the model axes."""
    fx = _flat_axis(mesh, p)
    cl = _axis_entry(data_axes(mesh))
    return P(cl, fx) if client_dims else P(fx)


def flat_state_pspecs(state: PyTree, mesh, p: int) -> PyTree:
    """Sharding for the flat round state: every (P,) server vector over the
    model axes, the (M, P) ν⁽ⁱ⁾ matrix's rows over the data axes."""
    fx = _flat_axis(mesh, p)
    cl = _axis_entry(data_axes(mesh))
    out = {}
    for k in state:
        if k == "round":
            out[k] = P()
        elif k == "nu_i":
            out[k] = P(cl, fx)
        else:
            out[k] = P(fx)
    return out


def flat_train_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     algo: Algorithm, k_max: int = 4,
                     master_dtype=None) -> dict:
    """``train_specs`` for the flat layout: the same batch stand-ins, the
    round state as (P,) / (M, P) buffers of ``core.flat.make_flat_spec``
    of the abstract parameter tree (``master_dtype``: the mixed-precision
    master buffer's)."""
    from repro_torch.core import flat as flat_lib

    m = n_clients(mesh)
    b_local, batches = _round_batches(cfg, shape, m, k_max)
    fspec = flat_lib.make_flat_spec(abstract_params(cfg),
                                    master_dtype=master_dtype)
    state = rounds.init_state(_sds((fspec.p,), fspec.dtype), m, algo)
    specs = {
        "state": state,
        "batches": batches,
        "k_steps": _sds((m,), torch.int32),
        "weights": _sds((m,), torch.float32),
    }
    pspecs = {
        "state": flat_state_pspecs(state, mesh, fspec.p),
        "batches": _batch_pspecs(batches, mesh),
        "k_steps": P(),
        "weights": P(),
    }
    return {"specs": specs, "pspecs": pspecs, "m": m, "b_local": b_local,
            "flat_spec": fspec}


# ---------------------------------------------------------------------------
# serve stand-ins (prefill / decode)
# ---------------------------------------------------------------------------

def cache_pspec(path, shape: tuple[int, ...], mesh, *, kind: str) -> Spec:
    """KV / SSM cache sharding.  Caches are stacked (n_groups, count,
    …leaf)."""
    name = _leaf_name(path)
    stack = 2
    msize, dsize = _msize(mesh), _dsize(mesh)
    d_ax = data_axes(mesh)
    spec: list = [None] * len(shape)
    if name in ("pos", "idx"):
        return Spec(spec)
    bdim = stack
    seq_dim = stack + 1
    if kind == "long":
        # batch = 1: shard the cache sequence axis over the data axes
        if (name in ("k", "v", "ckv", "krope")
                and shape[seq_dim] % max(dsize, 1) == 0):
            spec[seq_dim] = _axis_entry(d_ax)
    else:
        if d_ax and shape[bdim] % dsize == 0 and shape[bdim] >= dsize:
            spec[bdim] = _axis_entry(d_ax)
    # model axis: prefer the head-like dim, else any remaining divisible dim
    prefer = {"k": stack + 2, "v": stack + 2, "ssm": stack + 1,
              "C": stack + 1, "n": stack + 1, "m": stack + 1,
              "conv": stack + 2, "ckv": None, "krope": None}
    cand = prefer.get(name, None)
    dims = ([cand] if cand is not None else []) + [
        d for d in range(stack, len(shape)) if spec[d] is None]
    for d in dims:
        if d is None or d >= len(shape) or spec[d] is not None:
            continue
        if shape[d] % msize == 0 and shape[d] >= msize:
            spec[d] = "model"
            break
    return Spec(spec)


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> PyTree:
    return model_lib.init_caches(cfg, batch, max_len, device="meta")


def serve_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                kind: str) -> dict:
    """kind: "prefill" | "decode" | "long"."""
    params = abstract_params(cfg)
    param_ps = tree_pspecs(params, _msize(mesh))
    b = shape.global_batch
    d_ax = data_axes(mesh)
    # the batch's lead dim over the data axes; long decode's single row
    # replicated
    lead = _axis_entry(d_ax) if kind in ("prefill", "decode") else None
    if kind == "prefill":
        batch = _client_batch(cfg, b, shape.seq_len, labels=False)
    else:
        # decode: one token against a seq_len cache
        batch = _client_batch(cfg, b, 1, labels=False)
    batch_ps = {k: Spec((lead,) + (None,) * (x.dim() - 1))
                for k, x in batch.items()}
    caches = abstract_caches(cfg, b, shape.seq_len)
    cache_ps = map_with_path(
        lambda p, x: cache_pspec(p, tuple(x.shape), mesh, kind=kind),
        caches)
    return {"params": params, "param_ps": param_ps, "batch": batch,
            "batch_ps": batch_ps, "caches": caches, "cache_ps": cache_ps}


def bf16_config(cfg: ModelConfig) -> ModelConfig:
    """Production numerics: bf16 params and activations."""
    return dataclasses.replace(cfg, dtype="bfloat16")
