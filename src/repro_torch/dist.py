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
import math
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
    over this rank's ``local`` shard, with no communication, and no copy
    unless a shard of another shape is not contiguous (the global strides
    are then the contiguous ones, which the shard must follow).  A DTensor
    passes through."""
    from torch.distributed.tensor import DTensor
    if isinstance(local, DTensor):
        return local
    shape = tuple(local.shape if shape is None else shape)
    if shape == tuple(local.shape):
        stride = local.stride()
    else:
        local = local.contiguous()
        stride = _contiguous_stride(shape)
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

    Does nothing when no mesh is installed or ``x`` is a plain tensor.
    Under ``torch.func.vmap`` (a training round's local steps on a mesh)
    ``x`` is a batched tensor over a DTensor: ``on_physical`` redistributes
    the DTensor, its vmapped dim kept as it lies."""
    if _MESH is None:
        return x
    if len(names) != x.dim():
        raise ValueError(
            f"constrain: {len(names)} axis names for rank-{x.dim()} value")
    if _batched_dtensor(x):
        return on_physical(lambda p: _constrained(p, names, 1), x)
    if not is_dtensor(x):
        return x
    return _constrained(x, names)


# ---------------------------------------------------------------------------
# the local steps' explicit region
# ---------------------------------------------------------------------------

def _submesh(mesh, dims: Sequence[int]):
    """The sub-mesh of mesh dimensions ``dims``, or None where it has one
    rank."""
    if math.prod(mesh.size(i) for i in dims) <= 1:
        return None
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    return mesh[names if len(names) > 1 else names[0]]


def _model_dims(mesh, client_axes: Sequence[str]) -> tuple:
    """The mesh dims of more than one rank that are not client axes."""
    return tuple(i for i, n in enumerate(mesh.mesh_dim_names)
                 if n not in client_axes and mesh.size(i) > 1)


def model_submesh(mesh, client_axes: Sequence[str]):
    """The sub-mesh of ``mesh``'s dims other than ``client_axes`` (the
    model axes), or None where they have one rank between them."""
    return _submesh(mesh, _model_dims(mesh, client_axes))


class ClientRegion:
    """The explicit region in which a round's local steps run on a mesh
    (the counterpart of the reference's ``vmap`` with ``spmd_axis_name``,
    which ``torch.func.vmap`` does not have): ``m`` clients, their dim
    sharded over the mesh dims named in ``client_axes`` (the data axes).

    Inside the region each rank holds only its data slice's ``m_local``
    clients, rows ``start`` on, and the client axis never crosses ranks.
    ``down`` turns a client stack into this rank's rows and ``whole`` a
    value every client shares into this rank's copy: plain tensors where
    the other mesh dims (the model axes) have one rank between them, else
    DTensors on their sub-mesh ``sub``, placed there as before, so the
    model stays tensor-parallel.  ``up`` is ``down``'s inverse."""

    def __init__(self, mesh, client_axes: Sequence[str], m: int):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh, self.m = mesh, m
        self.other = _model_dims(mesh, client_axes)
        self.client = tuple(i for i, n in enumerate(mesh.mesh_dim_names)
                            if n in client_axes and mesh.size(i) > 1)
        self.sub = _submesh(mesh, self.other)
        self.rows_pl = tuple(Shard(0) if i in self.client else Replicate()
                             for i in range(mesh.ndim))
        self.start, self.m_local = local_offset(mesh, self.rows_pl, (m,), 0)

    def _to(self, t, pl):
        return t if tuple(t.placements) == pl else t.redistribute(self.mesh,
                                                                  pl)

    def _on_sub(self, local, pl, shape):
        if self.sub is None:
            return local
        return as_dtensor(local, self.sub, tuple(pl[i] for i in self.other),
                          shape)

    def down(self, t):
        """This rank's rows of the client stack ``t`` (a DTensor, or a
        whole tensor the same on every rank)."""
        if not is_dtensor(t):
            return t.narrow(0, self.start, self.m_local)
        from torch.distributed.tensor import Replicate, Shard
        t = self._to(t, tuple(
            Shard(0) if i in self.client else
            Replicate() if p.is_partial() or (p.is_shard() and p.dim == 0)
            else p for i, p in enumerate(t.placements)))
        return self._on_sub(t.to_local(), t.placements,
                            (self.m_local,) + tuple(t.shape[1:]))

    def whole(self, t):
        """This rank's copy of ``t``, a value every client shares (whole
        over the client dims)."""
        if not is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate
        t = self._to(t, tuple(
            Replicate() if i in self.client or p.is_partial() else p
            for i, p in enumerate(t.placements)))
        return self._on_sub(t.to_local(), t.placements, tuple(t.shape))

    def up(self, t):
        """``t``, this rank's client rows (plain, or a DTensor on the
        sub-mesh), as a DTensor client stack of the mesh: rows over the
        client dims, placed on the others as on the sub-mesh (a partial sum
        made whole first)."""
        if t is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        sub_pl = {}
        shape = (self.m,) + tuple(t.shape[1:])
        if is_dtensor(t):
            pl = tuple(Replicate() if p.is_partial() else p
                       for p in t.placements)
            if pl != tuple(t.placements):
                t = t.redistribute(self.sub, pl)
            sub_pl = dict(zip(self.other, pl))
            t = t.to_local()
        pl = tuple(Shard(0) if i in self.client else
                   sub_pl.get(i, Replicate()) for i in range(self.mesh.ndim))
        return as_dtensor(t, self.mesh, pl, shape)


def _rows_whole(pl) -> tuple:
    """``pl`` with every sharding of dim 0 replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_shard() and p.dim == 0 else p
                 for p in pl)


def take_rows(store: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``store.index_select(0, ids)``.  A DTensor store whose rows are
    sharded (the population's ν⁽ⁱ⁾ rows over the data axes) gathers
    explicitly: each rank picks the rows it holds, zeros elsewhere, and a
    sum over the row-sharding mesh dims makes every picked row whole
    there, exactly (one row plus zeros); the other placements stay."""
    if not is_dtensor(store):
        return store.index_select(0, ids)
    from torch.distributed.tensor import DTensor, Partial
    mesh, pl = store.device_mesh, tuple(store.placements)
    start, length = local_offset(mesh, pl, store.shape, 0)
    ids = ids.to(torch.int64)
    mine = (ids >= start) & (ids < start + length)
    rows = store.to_local().index_select(0, (ids - start).clamp(0, length - 1))
    rows = torch.where(mine.reshape((-1,) + (1,) * (rows.dim() - 1)), rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    partial = tuple(Partial() if p.is_shard() and p.dim == 0 else p
                    for p in pl)
    shape = (ids.shape[0],) + tuple(store.shape[1:])
    out = DTensor.from_local(rows, mesh, partial, run_check=False,
                             shape=torch.Size(shape),
                             stride=_contiguous_stride(shape))
    return out.redistribute(mesh, _rows_whole(pl))


def put_rows(store: torch.Tensor, ids: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """``store.index_copy_(0, ids, rows)``.  A DTensor store whose rows are
    sharded writes each rank's own rows from ``rows`` made whole over the
    row-sharding dims (ids that repeat must carry equal rows).  No shape
    depends on the ids: the ids another rank holds write the first own
    id's row again (or, with none, the shard's first row its own value),
    so every write to a row carries the same value."""
    if not is_dtensor(store):
        return store.index_copy_(0, ids, rows)
    mesh, pl = store.device_mesh, tuple(store.placements)
    start, length = local_offset(mesh, pl, store.shape, 0)
    whole = _rows_whole(pl)
    if is_dtensor(rows):
        rows = (rows if tuple(rows.placements) == whole
                else rows.redistribute(mesh, whole)).to_local()
    else:
        rows = shard_of(rows, mesh, whole)
    local = store.to_local()
    ids = ids.to(torch.int64)
    mine = (ids >= start) & (ids < start + length)
    first = torch.argmax(mine.to(torch.int8)).reshape(1)   # 0 if none
    own = mine.any()
    at = torch.where(mine, ids - start,
                     torch.where(own, ids.index_select(0, first) - start, 0))
    keep = torch.where(own, rows.index_select(0, first),
                       local[:1].to(rows.dtype))
    expand = mine.reshape((-1,) + (1,) * (rows.dim() - 1))
    local.index_copy_(0, at, torch.where(expand, rows, keep).to(local.dtype))
    return store


def rows_dot(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``torch.tensordot(w, a, dims=1)``: Σ_m w[m]·a[m] over the leading
    (client) dim.  For a DTensor ``a`` each rank sums its own rows (the
    same op on the local shard, so a mesh whose client dims have one rank
    gives the plain result bit for bit) and the partial sums are
    all-reduced over the client dims in ``a``'s dtype before anything
    else reads them; the other placements move down one dim."""
    if not is_dtensor(a):
        return torch.tensordot(w, a, dims=1)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, pl = a.device_mesh, tuple(a.placements)
    start, length = local_offset(mesh, pl, a.shape, 0)
    w = w.full_tensor() if is_dtensor(w) else w
    out = torch.tensordot(w.narrow(0, start, length), a.to_local(), dims=1)
    partial = tuple(Partial() if p.is_shard() and p.dim == 0
                    else Shard(p.dim - 1) if p.is_shard() else p
                    for p in pl)
    shape = tuple(a.shape[1:])
    out = DTensor.from_local(out, mesh, partial, run_check=False,
                             shape=torch.Size(shape),
                             stride=_contiguous_stride(shape))
    return out.redistribute(mesh, tuple(
        Replicate() if p.is_partial() else p for p in partial))


def _batched_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.func.vmap`` batched tensor over a
    DTensor."""
    from torch._C import _functorch
    return (_functorch.is_batchedtensor(x)
            and is_dtensor(_functorch.get_unwrapped(x)))


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor, or under ``torch.func.vmap`` a batched
    tensor over one."""
    return is_dtensor(x) or _batched_dtensor(x)


def on_physical(fn, *xs):
    """``fn(*xs)`` where the ``xs`` are DTensors, or under
    ``torch.func.vmap`` (a training round's local steps on a model mesh)
    batched tensors over DTensors: there ``fn`` runs on the physical
    DTensors, each vmapped dim moved to the front, and the front dim of
    what it returns is the vmapped one.  Autograd records the ops ``fn``
    runs, so its backward is theirs."""
    if not any(_batched_dtensor(x) for x in xs):
        return fn(*xs)
    return _OnPhysical.apply(fn, *xs)


class _OnPhysical(torch.autograd.Function):
    """``on_physical``'s vmap rule; only ever called under vmap."""

    @staticmethod
    def forward(fn, *xs):
        return fn(*xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("on_physical is differentiated through the ops "
                           "its vmap rule runs")

    @staticmethod
    def vmap(info, in_dims, fn, *xs):
        out = fn(*(x if d is None else x.movedim(d, 0)
                   for x, d in zip(xs, in_dims[1:])))
        return out, (0 if isinstance(out, torch.Tensor)
                     else tuple(0 for _ in out))


def _constrained(x, names, lead: int = 0):
    """The DTensor ``x`` redistributed to the placements of ``names`` for
    its last dims under the installed rules, its ``lead`` leading dims (a
    vmapped one) kept as they lie."""
    spec = [None] * lead + [_physical(n, s) for n, s in
                            zip(names, x.shape[lead:])]
    pl = tuple(p0 if p0.is_shard() and p0.dim < lead else p for p0, p in
               zip(x.placements, placements(spec, x.device_mesh)))
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _heads_whole(x, n: int):
    """The DTensor ``x`` with its last dim made whole where the mesh dims
    sharding it cut it into pieces that are not whole groups of ``n``
    (heads)."""
    last = x.dim() - 1
    cut = [i for i, p in enumerate(x.placements)
           if p.is_shard() and p.dim == last]
    if n % math.prod(x.device_mesh.size(i) for i in cut) == 0:
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if i in cut else p
               for i, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, pl)


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x (…, n·d)`` as ``(…, n, d)``.  A DTensor (or, under vmap, a
    batched DTensor) whose last dim is sharded in pieces that split a head
    (a model axis wider than ``n``) is made whole there first, as the
    reference's ``reshape`` reshards under XLA."""
    if _batched_dtensor(x):
        x = on_physical(lambda p: _heads_whole(p, n), x)
    elif is_dtensor(x):
        x = _heads_whole(x, n)
    return x.reshape(tuple(x.shape[:-1]) + (n, x.shape[-1] // n))
