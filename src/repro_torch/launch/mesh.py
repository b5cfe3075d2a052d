"""Mesh construction and logical-axis rules (``repro.launch.mesh``
counterpart) on ``torch.distributed``'s ``DeviceMesh``.

``make_production_mesh`` gives the reference's production layouts (one
pod of 16 × 16 = 256 ranks, two pods = 512) when the world has that many
ranks; ``make_local_mesh`` a ``(data, model)`` mesh over the ranks of a
small world.  The rule functions take any mesh: a ``DeviceMesh`` or a
stand-in with ``axis_names`` and a name → size ``shape`` (``dist.view``),
so the production layouts' specs are checked without 256 ranks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import view

# (variant, multi_pod) -> (shape, axis names)
_LAYOUTS = {
    ("tp16", False): ((16, 16), ("data", "model")),
    ("tp16", True): ((2, 16, 16), ("pod", "data", "model")),
    ("2d", False): ((16, 4, 4), ("data", "batch", "model")),
    ("2d", True): ((2, 16, 4, 4), ("pod", "data", "batch", "model")),
}


def production_layout(*, multi_pod: bool = False,
                      variant: str = "tp16") -> tuple[tuple, tuple]:
    """The production mesh's shape and axis names.  Same 256 / 512 ranks,
    two factorizations:

    tp16: (data=16, model=16), 16-way tensor parallelism inside each
        client slice;
    2d:   (data=16, batch=4, model=4), the 16 ranks of a client slice
        split into 4-way per-client batch parallelism × 4-way tensor
        parallelism."""
    if variant not in ("tp16", "2d"):
        raise ValueError(variant)
    return _LAYOUTS[(variant, multi_pod)]


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_mesh(device_type: str, shape: tuple, axes: tuple):
    """``init_device_mesh`` over a world of exactly ``prod(shape)``
    ranks.  A world of one with no process group gets one (a ``HashStore``
    group of one rank)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    if not dist.is_initialized() and need == 1:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if _world() != need:
        raise ValueError(f"a mesh of shape {shape} {axes} needs {need} "
                         f"ranks; this world has {_world()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, variant: str = "tp16",
                         device_type: str = "cuda"):
    """The production layout (``production_layout``) as a ``DeviceMesh``;
    raises ``ValueError`` naming the rank count unless the world has that
    many ranks."""
    shape, axes = production_layout(multi_pod=multi_pod, variant=variant)
    return _device_mesh(device_type, shape, axes)


def recommended_variant(cfg) -> str:
    """Per-family mesh factorization: MoE archs need the wide model axis
    for expert parallelism (tp16); dense, MQA and SSM trainers take the 2d
    variant."""
    return "tp16" if cfg.moe is not None else "2d"


def make_local_mesh(data: int = 2, model: int = 2,
                    device_type: str = "cuda"):
    """A ``(data, model)`` mesh over this world's ranks, on the card unless
    ``device_type="cpu"``; the world must have ``data · model`` ranks."""
    return _device_mesh(device_type, (data, model), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """All mesh axes that carry batch / client parallelism."""
    return tuple(a for a in view(mesh).axis_names if a in ("pod", "data"))


def model_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in view(mesh).axis_names if a == "model")


def mesh_rules(mesh, *, kind: str) -> dict[str, tuple[str, ...]]:
    """Logical → physical rules per step kind.

    train   : the client axis is the vmapped one; inside the per-client
              function dp is unmapped (or the 2d variant's batch axis).
    prefill/decode : batch over the data axes, tensor over model.
    long    : batch = 1, so dp unmapped; the KV cache's sequence over the
              data axes ("sp")."""
    names = view(mesh).axis_names
    batch = ("batch",) if "batch" in names else ()
    if kind == "train":
        return {"dp": batch, "mp": model_axes(mesh), "sp": ()}
    if kind in ("prefill", "decode"):
        return {"dp": data_axes(mesh) + batch, "mp": model_axes(mesh),
                "sp": ()}
    if kind == "long":
        return {"dp": batch, "mp": model_axes(mesh), "sp": data_axes(mesh)}
    raise ValueError(kind)


def n_clients(mesh) -> int:
    """Training clients = product of the data-like axes (one client a
    slice)."""
    shape = view(mesh).shape
    out = 1
    for a in data_axes(mesh):
        out *= shape[a]
    return out
