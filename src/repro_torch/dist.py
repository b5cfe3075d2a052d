"""Logical-axis sharding constraints (``repro.dist`` counterpart), on
``torch.distributed`` meshes.

``launch/mesh.py`` decides which physical mesh axes implement each logical
axis per step kind (``mesh_rules``); this module holds that decision in
process-global state, so model code annotates intermediates with logical
names only:

    constrain(h, "dp", None, "mp")     # (batch, seq, hidden)

Logical names: ``dp`` (batch / data parallel), ``mp`` (tensor / model
parallel), ``sp`` (sequence parallel: long-decode KV caches).  The model
code keeps whole-tensor semantics: under a mesh its tensors are DTensors,
whose ops insert their own collectives, and ``constrain`` redistributes a
DTensor to the placements its names give.  A plain tensor, or any tensor
with no mesh installed, passes through unchanged, so the model zoo runs as
it is on one device.

The reference's two rules hold:

* an axis whose physical size does not divide the dimension is dropped
  (that dimension stays replicated): KV heads on meshes wider than Hkv,
  vocab on odd vocab sizes;
* a rule may map a logical name to ``()`` (train mode maps ``dp`` to
  nothing, the client axis being the vmapped one): also replicated.

A mesh is a ``DeviceMesh`` or any object with ``axis_names`` and a name →
size ``shape`` mapping (``view`` turns the first into the second), so the
spec logic runs on a stand-in for a mesh of any size.  Kernels that have no
DTensor rule run on each rank's local shard: ``local_offset`` gives a
shard's place in the whole tensor, ``as_dtensor`` / ``distribute`` wrap
local or whole tensors.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence

import torch

# process-global current mesh + logical → physical rules; set by the launch
# layer (build_prefill / build_decode) around each step it runs
_MESH = None
_RULES: dict[str, tuple[str, ...]] = {}


class MeshView(NamedTuple):
    """A mesh's axis names and sizes, and the mesh itself (a
    ``DeviceMesh``, or ``None`` for a stand-in)."""
    axis_names: tuple[str, ...]
    shape: dict
    mesh: object = None


def view(mesh) -> MeshView:
    """``mesh`` as axis names and a name → size mapping: a ``DeviceMesh``
    reads its ``mesh_dim_names`` and ``shape``; a stand-in that already has
    ``axis_names`` and a mapping ``shape`` is taken as it is."""
    if isinstance(mesh, MeshView):
        return mesh
    if isinstance(getattr(mesh, "shape", None), dict):
        return MeshView(tuple(mesh.axis_names), dict(mesh.shape), None)
    names = tuple(mesh.mesh_dim_names or ())
    if len(names) != mesh.ndim:
        raise ValueError("a DeviceMesh needs mesh_dim_names, one per "
                         f"dimension; got {names} for {mesh.ndim} dims")
    return MeshView(names, dict(zip(names, mesh.shape)), mesh)


def set_mesh_rules(mesh, rules: dict[str, Sequence[str]]) -> None:
    """Install ``mesh`` and logical → physical ``rules`` for later
    ``constrain`` calls (idempotent; the last call wins)."""
    global _MESH, _RULES
    _MESH = mesh
    _RULES = {k: tuple(v) for k, v in rules.items()}


def unset_mesh() -> None:
    """Clear the mesh: every later ``constrain`` does nothing."""
    global _MESH, _RULES
    _MESH = None
    _RULES = {}


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict[str, Sequence[str]]] = None):
    """Install ``mesh`` (and ``rules``, where given) for the body and
    restore the previous mesh and rules on exit."""
    global _MESH, _RULES
    saved = (_MESH, _RULES)
    _MESH = mesh
    if rules is not None:
        _RULES = {k: tuple(v) for k, v in rules.items()}
    try:
        yield mesh
    finally:
        _MESH, _RULES = saved


def axis_size(name: str) -> int:
    """Total size of the mesh axes implementing logical axis ``name`` (1
    if unmapped or no mesh is installed)."""
    if _MESH is None:
        return 1
    shape = view(_MESH).shape
    out = 1
    for ax in _RULES.get(name, ()):
        out *= shape[ax]
    return out


def _physical(name: Optional[str], dim: int):
    """Physical axes for one tensor dimension, or None to replicate."""
    if name is None or _MESH is None:
        return None
    axes = _RULES.get(name, ())
    shape = view(_MESH).shape
    size = 1
    for ax in axes:
        size *= shape[ax]
    if not axes or size <= 1:
        return None
    if dim % size != 0:              # non-dividing axis: keep replicated
        return None
    return axes if len(axes) > 1 else axes[0]


# ---------------------------------------------------------------------------
# specs → placements, and tensors on a mesh
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    if not hasattr(x, "placements"):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements on ``mesh``, one per mesh axis, of a
    per-dimension ``spec`` (each entry ``None``, an axis name or a tuple
    of axis names): ``Shard`` of the dimension an axis appears in,
    ``Replicate`` elsewhere.  A tuple entry shards its dimension over its
    axes, the first the outermost, as the mesh orders them.  An axis of
    size 1 replicates: a shard of one piece is the whole, and DTensor's
    view rules refuse to merge dims "sharded" that way."""
    from torch.distributed.tensor import Replicate, Shard
    v = view(mesh)
    out = []
    for ax in v.axis_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == ax or (isinstance(e, tuple) and ax in e)), None)
        out.append(Replicate() if dim is None or v.shape[ax] == 1
                   else Shard(dim))
    return tuple(out)


def _shard_dims(pl) -> list:
    """``(mesh dim, tensor dim)`` of every ``Shard`` placement."""
    return [(i, p.dim) for i, p in enumerate(pl) if p.is_shard()]


def local_offset(mesh, pl, shape: Sequence[int], dim: int) -> tuple[int, int]:
    """``(start, length)`` of this rank's shard of a ``shape`` tensor with
    placements ``pl`` along ``dim``: the mesh dimensions sharding it split
    it in mesh order, the first the outermost, in even pieces."""
    start, length = 0, shape[dim]
    for i, d in _shard_dims(pl):
        if d != dim:
            continue
        n = mesh.size(i)
        if length % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split evenly over mesh dim {i} ({n})")
        length //= n
        start += mesh.get_local_rank(i) * length
    return start, length


def shard_of(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (a view where it can
    be)."""
    for d in sorted({d for _, d in _shard_dims(pl)}):
        start, length = local_offset(mesh, pl, t.shape, d)
        t = t.narrow(d, start, length)
    return t


def _contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def as_dtensor(local: torch.Tensor, mesh, pl,
               shape: Optional[Sequence[int]] = None):
    """A DTensor of global ``shape`` (default: ``local``'s, replicated)
    over this rank's ``local`` shard, with no copy and no communication.
    A DTensor passes through."""
    from torch.distributed.tensor import DTensor
    if isinstance(local, DTensor):
        return local
    shape = tuple(local.shape if shape is None else shape)
    stride = (local.stride() if shape == tuple(local.shape)
              else _contiguous_stride(shape))
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def distribute(t: torch.Tensor, mesh, pl, device=None):
    """The whole tensor ``t`` placed by ``pl``: each rank keeps its own
    shard (moved to ``device`` if given), and a replicated tensor already
    on ``device`` is wrapped as it is, without a copy."""
    local = shard_of(t, mesh, pl)
    if local.shape != t.shape:
        local = local.contiguous()          # owns its shard, not the whole
    if device is not None:
        local = local.to(device)
    return as_dtensor(local, mesh, pl, t.shape)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the placements its logical axis
    ``names`` (one per dim) give under the installed rules.

    Does nothing when no mesh is installed or ``x`` is a plain tensor."""
    if _MESH is None:
        return x
    if len(names) != x.dim():
        raise ValueError(
            f"constrain: {len(names)} axis names for rank-{x.dim()} value")
    if not is_dtensor(x):
        return x
    spec = [_physical(n, d) for n, d in zip(names, x.shape)]
    pl = placements(spec, _MESH)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)
