"""Msgpack checkpoints of nested tensor trees (``repro.checkpoint.serialize``
counterpart), in the reference's file format.

Format: one msgpack map from each leaf's key path to ``{"dtype", "shape",
"data"}``: the numpy dtype name (bf16 is ``"bfloat16"``, as ``ml_dtypes``
names it), the shape as a list and the raw little-endian bytes.  A key
path joins dict keys and list / tuple indices with ``/``, and leaves come
in the reference's flattening order (dict keys sorted), so the port writes
the bytes the reference writes for the same arrays and a file of either
package loads in the other.  The encoder is the port's own
(``checkpoint/_msgpack.py``): the ``msgpack`` package is not needed.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

PyTree = Any
Device = Union[str, torch.device, None]

# numpy's dtype names of the torch dtypes a checkpoint holds
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _flatten(tree: PyTree, path: tuple = ()) -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _record(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype not in _NAMES:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        data = raw.numpy().reshape(-1)
        return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                "data": memoryview(data).cast("B") if data.size else b""}
    # order="C", not ascontiguousarray: a 0-d leaf (a snapshot's version)
    # keeps its shape () as in the reference's file
    arr = np.asarray(leaf, order="C")
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": memoryview(arr.reshape(-1)).cast("B")
            if arr.size else b""}


def save(path: str, tree: PyTree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors or numpy
    arrays) to ``path``, through ``path + ".tmp"`` and ``os.replace``."""
    payload = {key: _record(leaf) for key, leaf in _flatten(tree)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        for chunk in _msgpack.pack_chunks(payload):
            f.write(chunk)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    data = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(data) != len(data):
            raise OSError(f"short read of {path}")
    return _msgpack.unpackb(data)


def _host(rec: dict) -> torch.Tensor:
    """The saved leaf as a CPU tensor over the file's buffer (no copy)."""
    name = rec["dtype"]
    if name not in _DTYPES:
        raise TypeError(f"cannot restore dtype {name!r}")
    dtype, shape = _DTYPES[name], tuple(rec["shape"])
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype
                                               ).element_size()
    data = rec["data"]
    if len(data) != nbytes:
        raise ValueError(f"{len(data)} bytes for a {name} leaf of shape "
                         f"{shape}")
    if not nbytes:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(data, dtype=torch.uint8).view(dtype).reshape(
        shape)


def _sharded(rec: dict, key: str, sharding_fn: Callable, device: Device):
    """The leaf as a DTensor where ``sharding_fn(key, array)`` gives a
    ``(mesh, placements)``: each rank cuts its own shard from the file's
    array and moves only that to the mesh's device (``device`` where
    given), so no rank builds a whole device copy.  ``None`` if the
    function gives ``None``."""
    from repro_torch import dist
    full = _host(rec)
    target = sharding_fn(key, full)
    if target is None:
        return None
    mesh, pl = target
    dev = torch.device(device if device is not None else mesh.device_type)
    local = dist.shard_of(full, mesh, pl).contiguous().to(dev)
    return dist.as_dtensor(local, mesh, tuple(pl), full.shape)


def _tensor(rec: dict, device: torch.device) -> torch.Tensor:
    """The saved leaf as a tensor of its own on ``device``: the bytes go
    to the device once, from the file's buffer."""
    host = _host(rec)
    return torch.empty(host.shape, dtype=host.dtype,
                       device=device).copy_(host)


def _unflatten(like: PyTree, leaves: dict, path: tuple = ()) -> PyTree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, path + (str(i),))
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return leaves["/".join(path)]


def load(path: str, like: PyTree, device: Device = None,
         sharding_fn: Optional[Callable] = None) -> PyTree:
    """Restore into the structure of ``like``: each leaf on its ``like``
    leaf's device (a tensor's; the CPU for other leaves), or on ``device``
    where given, with the saved dtype.  Raises ``KeyError`` on a missing
    leaf and ``ValueError`` on a shape mismatch, as the reference does.

    ``sharding_fn(key, array) -> (mesh, placements) | None`` restores a
    leaf straight onto a ``DeviceMesh`` as a DTensor: ``array`` is the
    file's leaf as a CPU tensor over the file's bytes, and each rank moves
    only its own shard to the device (the reference's sharded restore);
    ``None`` restores that leaf as above."""
    payload = _read(path)
    leaves = {}
    for key, proto in _flatten(like):
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = payload[key]
        shape = tuple(rec["shape"])
        proto_shape = (tuple(proto.shape) if isinstance(proto, torch.Tensor)
                       else np.shape(proto))
        if shape != proto_shape:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{shape} vs {proto_shape}")
        if sharding_fn is not None:
            leaf = _sharded(rec, key, sharding_fn, device)
            if leaf is not None:
                leaves[key] = leaf
                continue
        dev = (torch.device(device) if device is not None
               else proto.device if isinstance(proto, torch.Tensor)
               else torch.device("cpu"))
        leaves[key] = _tensor(rec, dev)
    return _unflatten(like, leaves)


def load_raw(path: str) -> dict[str, torch.Tensor]:
    """Restore WITHOUT a ``like`` structure: the path-keyed flat dict of CPU
    tensors exactly as saved (the schema-free path serving snapshots
    restore through)."""
    return {key: _tensor(rec, torch.device("cpu"))
            for key, rec in _read(path).items()}


def save_every(path_fmt: str, every: int) -> Callable:
    """``callback(round, tree)`` that saves to ``path_fmt.format(round=t)``
    every ``every`` rounds."""
    def cb(t: int, tree: PyTree) -> None:
        if every > 0 and t % every == 0:
            save(path_fmt.format(round=t), tree)
    return cb
