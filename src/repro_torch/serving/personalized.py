"""Per-client personalized serving over the shared flat master buffer
(``repro.serving.personalized`` counterpart).

FedaGrac training keeps a per-client correction signal, the ``(M, P)``
ν⁽ⁱ⁾ rows.  This module serves it: every ``Request.client_id`` resolves to
a parameter VIEW

    row(cid) = flat_master + delta(cid)

with the delta from the ``PERSONALIZERS`` registry:

    "none"     delta = 0: the shared base, served through the plain
               ``ServeEngine``'s own calls (bit-equal to it).
    "nu"       delta = scale · (ν⁽ⁱ⁾[cid] − ν), from the training state's
               ``(M, P)`` rows.
    "lowrank"  delta = scale · coeff[cid] @ basis: an ``(M, r)`` table of
               coefficients against a shared ``(r, P)`` orthonormal basis
               (``lowrank_factors``), O(M·r + r·P) storage.

A request's row is resolved ONCE, at admission: the summed ``(P,)`` row
and the snapshot version are pinned to its slot, so requests of different
clients and versions decode in one tick, and ``swap()`` between ticks
changes only later admissions.  Completions record their version.

A decode tick takes the cheapest sound path for the slots it holds:

  * one live version and no deltas: the plain engine's ``_decode_tick``
    with that version's parameter tree, materialized once per version;
  * several live versions, no deltas: one shared decode per version over
    the whole pool, each slot's logits and cache row taken from its own
    version's call (``_take_slot``; batch rows are independent);
  * any delta: the row path, ``personalized_decode``: a batch-1
    ``serve_decode`` on each slot's own ``(P,)`` row through the view
    table, ``torch.func.vmap``-ed over the pool (cache batch axis 2).

The rows of the row path live in one ``(slots, P)`` buffer, written at
admission: a tick reads them in place and copies no row.  The engine runs
on the card unless given ``device="cpu"``; a snapshot's tensors move to
it when the snapshot is registered.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import serialize
from repro_torch.configs.base import ModelConfig
from repro_torch.core import flat as flat_lib
from repro_torch.core.tree_util import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import Request, ServeEngine

Snapshot = Dict[str, Any]

# -- snapshots ----------------------------------------------------------------


def make_snapshot(version: int, flat_master, nu=None, nu_i=None,
                  coeff=None, basis=None) -> Snapshot:
    """A versioned publication of training state: the ``(P,)`` master plus
    whatever per-client signal the personalizer kind needs."""
    snap: Snapshot = {"version": np.int32(version),
                      "flat_master": torch.as_tensor(flat_master)}
    for k, v in (("nu", nu), ("nu_i", nu_i),
                 ("coeff", coeff), ("basis", basis)):
        if v is not None:
            snap[k] = torch.as_tensor(v)
    return snap


def save_snapshot(path: str, snap: Snapshot) -> None:
    serialize.save(path, snap)


def load_snapshot(path: str) -> Snapshot:
    """A snapshot file of either package, as CPU tensors."""
    raw = serialize.load_raw(path)
    return {k: np.int32(int(v)) if k == "version" else v
            for k, v in raw.items()}


def lowrank_factors(nu_i, nu, r: int):
    """Factor the ν correction rows into ``(M, r)`` coefficients against a
    shared ``(r, P)`` orthonormal basis of their row space, so serving
    stores O(M·r + r·P) instead of O(M·P).  Exact when rank(rows) ≤ r.

    The basis comes from Gram-Schmidt over the M rows (the reference
    takes a QR of the ``(P, M)`` transpose, which the card's solver cannot
    take at P ≈ 7·10⁸).  Each row is orthogonalized and normalized three
    times: a row in (or near) the span of the earlier ones leaves rounding
    noise, which the later passes make orthogonal, as a QR's column would
    be (ν − mean ν⁽ⁱ⁾ rows are dependent).  Only the span matters:
    ``coeff @ basis`` is the projection onto it, whatever the signs.  A
    zero row adds a zero basis row.  Each basis row is worked on in place,
    and dot products and norms accumulate in float64 (``_dots``)."""
    rows = torch.as_tensor(nu_i) - torch.as_tensor(nu)[None]      # (M, P)
    r = min(r, rows.shape[0], rows.shape[1])
    basis = rows.new_zeros((r, rows.shape[1]))
    tiny = torch.finfo(rows.dtype).tiny
    for j in range(r):
        v = basis[j]
        v.copy_(rows[j])
        for _ in range(3):
            v -= _dots(basis[:j], v).to(v.dtype) @ basis[:j]
            v /= _dots(v, v).sqrt().to(v.dtype).clamp_min(tiny)
    coeff = torch.stack([_dots(rows, b) for b in basis], 1)
    return coeff.to(rows.dtype), basis


# the entries a float64 partial sum of ``_dots`` covers
_DOT_CHUNK = 1 << 24


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise ``a · b`` over the last axis, in float64: float32 products
    summed chunk by chunk in float64.  (A float32 sum over P ≈ 7·10⁸
    entries in a matrix product's order drifts by ~10⁻³, and a float64
    copy of the whole product would take twice its memory.)"""
    out = a.new_zeros(a.shape[:-1], dtype=torch.float64)
    for i in range(0, a.shape[-1], _DOT_CHUNK):
        out += (a[..., i:i + _DOT_CHUNK] * b[..., i:i + _DOT_CHUNK]
                ).sum(-1, dtype=torch.float64)
    return out


# -- personalizer registry ----------------------------------------------------
# Each entry: (snapshot, scale) -> resolve(client_id) -> (P,) delta | None.
# None means "serve the shared base": the "none" kind and cold-start clients
# outside the stored population land there, which keeps the shared decode
# path reachable slot by slot.


def _resolve_none(snap: Snapshot, scale: float) -> Callable:
    return lambda cid: None


def _resolve_nu(snap: Snapshot, scale: float) -> Callable:
    nu_i, nu = snap.get("nu_i"), snap.get("nu")
    if nu_i is None or nu is None:
        raise ValueError('personalizer "nu" needs snapshot keys '
                         '"nu_i" and "nu"')
    m = nu_i.shape[0]

    def resolve(cid: int):
        if not 0 <= cid < m:
            return None                          # cold start → shared base
        return scale * (nu_i[cid] - nu)
    return resolve


def _resolve_lowrank(snap: Snapshot, scale: float) -> Callable:
    coeff, basis = snap.get("coeff"), snap.get("basis")
    if coeff is None or basis is None:
        raise ValueError('personalizer "lowrank" needs snapshot keys '
                         '"coeff" and "basis" (see lowrank_factors)')
    m = coeff.shape[0]

    def resolve(cid: int):
        if not 0 <= cid < m:
            return None
        return scale * (coeff[cid] @ basis)      # (r,) @ (r, P)
    return resolve


PERSONALIZERS: Dict[str, Callable] = {
    "none": _resolve_none,
    "nu": _resolve_nu,
    "lowrank": _resolve_lowrank,
}


def make_personalizer(name: str, snap: Snapshot,
                      scale: float = 1.0) -> Callable:
    if name not in PERSONALIZERS:
        raise ValueError(f"unknown personalizer {name!r}; "
                         f"choose from {sorted(PERSONALIZERS)}")
    return PERSONALIZERS[name](snap, scale)


# -- functional decode core ---------------------------------------------------


def personalized_decode(spec: flat_lib.FlatSpec, cfg: ModelConfig,
                        rows: torch.Tensor, tokens: torch.Tensor,
                        caches: list, offsets: torch.Tensor):
    """Batched decode where every slot runs its OWN ``(P,)`` parameter row
    through the view table: ``torch.func.vmap`` of a batch-1
    ``serve_decode`` over (row, token, cache row, offset).  Cache leaves
    carry their batch dim at axis 2 (``(n_groups, count, B, …)``,
    ``models.model.init_caches``), so the whole cache list maps with one
    axis.  ``rows`` (B, P), ``tokens`` (B, 1), ``offsets`` (B,); returns
    ((B, V) logits, new caches)."""
    def one(row, tok, cache, off):
        params = flat_lib.view_tree(spec, row)
        c1 = tree_map(lambda x: x[:, :, None], cache)
        logits, c1 = model_lib.serve_decode(
            params, {"tokens": tok[None]}, c1, off, cfg)
        return logits[0, 0], tree_map(lambda x: x[:, :, 0], c1)

    return torch.func.vmap(one, in_dims=(0, 0, 2, 0), out_dims=(0, 2))(
        rows, tokens, caches, offsets)


# -- the engine ---------------------------------------------------------------


class PersonalizedServeEngine(ServeEngine):
    """ServeEngine where ``Request.client_id`` selects a parameter view and
    ``swap(snapshot)`` hot-swaps the base between ticks."""

    def __init__(self, cfg: ModelConfig, spec: flat_lib.FlatSpec,
                 snapshot: Snapshot, *, personalizer: str = "none",
                 scale: float = 1.0, **kw):
        self.device = resolve_device(kw.get("device"))
        self.spec = spec
        self.kind = personalizer
        self.scale = scale
        self._versions: Dict[int, dict] = {}
        self.version = self._register(snapshot)
        super().__init__(cfg, self._versions[self.version]["params"], **kw)
        # per-slot pins, set at admission: the snapshot version and (row
        # path only) the slot's summed (P,) row, a row of self._rows
        self._slot_ver: list[Optional[int]] = [None] * self.slots
        self._slot_row: list[Optional[torch.Tensor]] = [None] * self.slots
        self._rows = (None if personalizer == "none" else
                      torch.zeros((self.slots, spec.p), dtype=spec.dtype,
                                  device=self.device))

    # -- snapshot lifecycle ---------------------------------------------------

    @torch.inference_mode()
    def _register(self, snap: Snapshot) -> int:
        v = int(snap["version"])
        snap = {k: (t.to(self.device) if isinstance(t, torch.Tensor)
                    else t) for k, t in snap.items()}
        base = snap["flat_master"]
        # the view materialized ONCE per version: the shared path then runs
        # the plain engine's calls on a tree of tensors that own their data
        self._versions[v] = {
            "base": base,
            "params": flat_lib.unravel(self.spec, base),
            "resolve": make_personalizer(self.kind, snap, self.scale),
        }
        return v

    def swap(self, snap: Snapshot) -> int:
        """Install a new snapshot for FUTURE admissions.  In-flight slots
        keep their pinned version and row and their caches: a swap between
        ticks cannot change an admitted request's tokens."""
        self.version = self._register(snap)
        self.params = self._versions[self.version]["params"]
        self._gc_versions()
        return self.version

    def _gc_versions(self) -> None:
        live = {self.version} | {v for v in self._slot_ver if v is not None}
        for v in [v for v in self._versions if v not in live]:
            del self._versions[v]

    def resolve(self, client_id: int):
        """The current version's delta for ``client_id`` (None = base)."""
        return self._versions[self.version]["resolve"](client_id)

    # -- engine hooks ---------------------------------------------------------

    def step(self) -> None:
        super().step()
        for s in range(self.slots):
            if self.active[s] is None:
                self._slot_ver[s] = None
                self._slot_row[s] = None
        self._gc_versions()

    def _prefill_slot(self, s: int, req: Request, toks, caches):
        v = self.version
        ver = self._versions[v]
        delta = ver["resolve"](req.client_id)
        self._slot_ver[s] = v
        if self._rows is not None:
            # the row path reads every slot's row: base-only slots too
            self._rows[s] = ver["base"]
        if delta is None:
            # shared base: the plain engine's prefill on this version's
            # materialized tree
            self._slot_row[s] = None
            params = ver["params"]
        else:
            # pin the SUMMED row now: later swaps cannot touch it
            self._rows[s] += delta
            self._slot_row[s] = self._rows[s]
            params = flat_lib.view_tree(self.spec, self._slot_row[s])
        logits, new_caches, _ = model_lib.forward(
            params, {"tokens": toks}, self.cfg, caches=caches)
        return logits, new_caches

    def _decode_tick(self, toks: np.ndarray, live: list[int]):
        if any(self._slot_row[s] is not None for s in live):
            return self._decode_rows(toks)
        versions = sorted({self._slot_ver[s] for s in live})
        if len(versions) == 1:
            # the plain engine's own call (and the "none" bit-equality)
            self.params = self._versions[versions[0]]["params"]
            return super()._decode_tick(toks, live)
        return self._decode_grouped(toks, live, versions)

    def _decode_rows(self, toks: np.ndarray) -> torch.Tensor:
        """Row path: every slot decodes its own pinned ``(P,)`` row (an
        idle slot its stale one: its logits are not read and its cache row
        is overwritten at its next admission)."""
        logits, self.caches = personalized_decode(
            self.spec, self.cfg, self._rows,
            torch.from_numpy(toks).to(self.device), self.caches,
            torch.from_numpy(self.pos.copy()).to(self.device))
        return logits

    def _decode_grouped(self, toks: np.ndarray, live: list[int],
                        versions: list[int]) -> torch.Tensor:
        """Several snapshot versions share the pool (a hot-swap with
        base-only slots in flight): the shared batched decode once PER
        VERSION over the whole pool, each slot's row kept from its own
        version's call.  Row independence makes the splice exact."""
        tok_dev = torch.from_numpy(toks).to(self.device)
        offs = torch.from_numpy(self.pos.copy()).to(self.device)
        outs = {v: model_lib.serve_decode(
            self._versions[v]["params"], {"tokens": tok_dev}, self.caches,
            offs, self.cfg) for v in versions}
        logits, cache = outs[versions[0]]
        logits = logits[:, 0]
        for v in versions[1:]:
            lv, cv = outs[v]
            for s in live:
                if self._slot_ver[s] == v:
                    logits[s] = lv[s, 0]
                    _take_slot(cache, cv, s)
        self.caches = cache
        return logits

    def _slot_version(self, s: int) -> int:
        return self._slot_ver[s] or 0


def _take_slot(dst: list, src: list, s: int) -> None:
    """Copy batch row ``s`` (cache axis 2) of ``src`` into ``dst``, in
    place."""
    for dseg, sseg in zip(dst, src):
        for key, d in dseg.items():
            o = sseg[key]
            if d.dim() >= 3 and d.shape == o.shape:
                d[:, :, s:s + 1] = o[:, :, s:s + 1]
