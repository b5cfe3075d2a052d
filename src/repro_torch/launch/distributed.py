"""Multi-process bootstrap (``repro.launch.distributed`` counterpart).

Every process runs the same program; ``bootstrap()`` starts the
``torch.distributed`` process group from explicit arguments or the
cluster's environment (``COORDINATOR_ADDRESS`` as ``host:port``,
``NUM_PROCESSES``, ``PROCESS_ID``), then the launcher builds its mesh over
the group's ranks.  Each host materializes only the examples of the
clients whose data slices have a rank on it (``host_client_slice``): the
batchers are deterministic in (seed, round), so no data service is needed.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.dist import view


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def bootstrap(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None) -> None:
    """Start the process group (``tcp://`` rendezvous at ``coordinator``).
    Does nothing for a single process, or where a group already runs."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = (process_id if process_id is not None
                  else _int_env("PROCESS_ID"))
    if num_processes in (None, 1) and coordinator is None:
        return                                    # single process
    if dist.is_initialized():
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("bootstrap needs the coordinator address, the "
                         "number of processes and this process's id")
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)


def _host_ranks() -> set:
    """The ranks on this host: blocks of ``LOCAL_WORLD_SIZE`` consecutive
    ranks (as launchers number them); every rank where that is unset."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return {0}
    world, rank = dist.get_world_size(), dist.get_rank()
    per_host = _int_env("LOCAL_WORLD_SIZE") or world
    first = rank // per_host * per_host
    return set(range(first, min(first + per_host, world)))


def host_client_slice(mesh) -> tuple[int, int]:
    """[start, stop) client ids whose data-axis slices have a rank on this
    host: the range of client datasets this host must materialize."""
    v = view(mesh)
    axes = [a for a in v.axis_names if a in ("pod", "data")]
    if not axes:
        return 0, 1
    local = _host_ranks()
    names = list(v.axis_names)
    # a client index is the flattened (pod, data) coordinate; it is local
    # if any of its ranks is
    client_idx = [names.index(a) for a in axes]
    other_idx = [i for i in range(len(names)) if i not in client_idx]
    grid = v.mesh.mesh.permute(client_idx + other_idx)
    n = 1
    for a in axes:
        n *= v.shape[a]
    flat = grid.reshape(n, -1)
    mine = [i for i in range(n) if any(int(r) in local for r in flat[i])]
    if not mine:
        return 0, 0
    return min(mine), max(mine) + 1


def is_coordinator() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_global_devices(tag: str) -> None:
    """Barrier across processes (checkpoint boundaries, round epochs);
    ``tag`` names it for the reader."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
