"""One rank of the port's sharded-serving check (``test_torch_launch_serve``):
a ``gloo`` group of ``WORLD`` ranks on a ``(2, 2)`` ``("data", "model")``
CPU mesh, run as

    python tests/_torch_mesh_worker.py RANK WORLD DIR

with ``DIR`` holding the ``FileStore``, the inputs the test wrote
(``inputs.npz``, the reduced models' weights as ``{arch}.msgpack``) and,
afterwards, what the ranks found: rank 0's results (``out.npz``, whole
tensors) and each rank's failed checks (``checks_{rank}.json``).  It
imports torch and the port only."""
from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as tdist

ARCHS = ("llama3-8b", "gemma-2b")
REFUSED = "granite-moe-1b-a400m"


def _cfg(name):
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    cfg = reduced(get_arch(name), n_layers=2, d_model=128)
    return dataclasses.replace(cfg, vocab=256)


def _shares(tree, pspecs, mesh, what: str, fails: list) -> int:
    """Check that every leaf a spec shards is sharded: its local shape is
    its share of the whole; returns how many sharded leaves there were."""
    from repro_torch import dist
    from repro_torch.launch import specs as specs_lib
    n = 0
    for path, t in specs_lib.leaves_with_path(tree):
        spec = pspecs
        for key in path:
            spec = spec[key]
        pl = dist.placements(spec, mesh)
        want = list(t.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                want[p.dim] //= mesh.size(i)
        if tuple(t.placements) != pl:
            fails.append(f"{what} {path}: placements {t.placements}, "
                         f"spec {tuple(spec)}")
        if list(t.to_local().shape) != want:
            fails.append(f"{what} {path}: local {tuple(t.to_local().shape)}"
                         f", share {tuple(want)}")
        n += any(p.is_shard() for p in pl)
    return n


def main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(os.path.join(root, "store"), world),
        rank=rank, world_size=world)
    from repro_torch.checkpoint import serialize
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import flat
    from repro_torch.launch import serve, specs as specs_lib
    from repro_torch.launch.distributed import host_client_slice
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M

    mesh = make_local_mesh(2, 2, device_type="cpu")
    inp = np.load(os.path.join(root, "inputs.npz"))
    out, fails, counts = {}, [], {}
    out["host_slice"] = np.array(host_client_slice(mesh))
    for arch in ARCHS:
        cfg = _cfg(arch)
        like = specs_lib.abstract_params(cfg)
        params = serialize.load(os.path.join(root, f"{arch}.msgpack"), like,
                                device="cpu")
        toks = torch.from_numpy(inp[f"{arch}/prompt"]).long()
        steps = torch.from_numpy(inp[f"{arch}/steps"]).long()
        B, S = toks.shape
        L = int(inp["cache_len"])
        pre, pb = serve.build_prefill(
            cfg, ShapeConfig("p", seq_len=L, global_batch=B, kind="prefill"),
            mesh)
        placed = serve.place(params, pb["param_ps"], mesh)
        counts[f"{arch}/params"] = _shares(placed, pb["param_ps"], mesh,
                                           f"{arch} params", fails)
        logits, caches = pre(placed, {"tokens": toks},
                             M.init_caches(cfg, B, L, device="cpu"))
        out[f"{arch}/prefill"] = logits.full_tensor().numpy()
        counts[f"{arch}/prefill_caches"] = _shares(
            caches, pb["cache_ps"], mesh, f"{arch} prefill caches", fails)
        dec, db = serve.build_decode(
            cfg, ShapeConfig("d", seq_len=L, global_batch=B, kind="decode"),
            mesh)
        got = []
        for i in range(steps.shape[1]):
            logits, caches = dec(placed, {"tokens": steps[:, i:i + 1]},
                                 caches, S + i)
            got.append(logits.full_tensor().numpy())
        out[f"{arch}/decode"] = np.stack(got, 1)
        counts[f"{arch}/decode_caches"] = _shares(
            caches, db["cache_ps"], mesh, f"{arch} decode caches", fails)
        if arch != "llama3-8b":
            continue
        # long decode: one row, its cache's sequence over "data"; the
        # prompt's prefill unsharded
        with torch.no_grad():
            _, row_caches = M.serve_prefill(
                params, {"tokens": toks[:1]}, cfg,
                caches=M.init_caches(cfg, 1, L, device="cpu"))
        lng, lb = serve.build_decode(
            cfg, ShapeConfig("l", seq_len=L, global_batch=1, kind="decode"),
            mesh, kind="long")
        got = []
        for i in range(steps.shape[1]):
            logits, row_caches = lng(placed, {"tokens": steps[:1, i:i + 1]},
                                     row_caches, S + i)
            got.append(logits.full_tensor().numpy())
        out["long"] = np.stack(got, 1)
        counts["long_caches"] = _shares(row_caches, lb["cache_ps"], mesh,
                                        "long caches", fails)
        # personalized decode on the prefill's caches
        fspec = flat.make_flat_spec(params)
        base = flat.ravel(fspec, params)
        deltas = torch.from_numpy(inp["deltas"])
        per, perb = serve.build_personalized_decode(
            cfg, ShapeConfig("d", seq_len=L, global_batch=B, kind="decode"),
            mesh, fspec)
        _, pre_caches = pre(placed, {"tokens": toks},
                            M.init_caches(cfg, B, L, device="cpu"))
        logits, pcaches = per(base, deltas, {"tokens": steps[:, :1]},
                              pre_caches, S)
        out["personalized"] = logits.full_tensor().numpy()
        counts["personalized_caches"] = _shares(
            pcaches, perb["cache_ps"], mesh, "personalized caches", fails)
        # restore straight onto the mesh, then the same prefill
        specs = {"/".join(map(str, p)): ps for p, ps in
                 specs_lib.leaves_with_path(pb["param_ps"])}
        restored = serialize.load(
            os.path.join(root, f"{arch}.msgpack"), like,
            sharding_fn=lambda key, a: (mesh, serve.dist.placements(
                specs[key], mesh)))
        counts["restored"] = _shares(restored, pb["param_ps"], mesh,
                                     "restored params", fails)
        logits, _ = pre(restored, {"tokens": toks},
                        M.init_caches(cfg, B, L, device="cpu"))
        out["restored_prefill"] = logits.full_tensor().numpy()
    try:
        serve.build_prefill(_cfg(REFUSED), ShapeConfig(
            "p", seq_len=16, global_batch=4, kind="prefill"), mesh)
        out["refusal"] = np.array("no error")
    except NotImplementedError as e:
        out["refusal"] = np.array(str(e))
    if rank == 0:
        np.savez(os.path.join(root, "out.npz"), **out)
    with open(os.path.join(root, f"checks_{rank}.json"), "w") as f:
        json.dump({"fails": fails, "sharded_leaves": counts}, f)
    tdist.barrier()
    tdist.destroy_process_group()


if __name__ == "__main__":
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    try:
        main(rank, world, root)
    except BaseException:
        with open(os.path.join(root, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
