"""One rank of the port's sharded-training check (``test_torch_launch_train``):
a ``gloo`` group of ``WORLD`` ranks on a ``(2, 2)`` ``("data", "model")`` CPU
mesh, run as

    python tests/_torch_train_mesh_worker.py RANK WORLD DIR

with ``DIR`` holding the ``FileStore``, the inputs the test wrote
(``inputs.npz``, the reduced model's weights as ``weights.msgpack``) and,
afterwards, what the ranks found: rank 0's results (``out.npz``, whole
tensors) and each rank's failed checks (``checks_{rank}.json``).  It imports
torch and the port only (``_shares`` from the serving worker beside it)."""
from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as tdist

from _torch_mesh_worker import _shares

ARCH = "llama3-8b"
REFUSED = "granite-moe-1b-a400m"
# (key, layout, algorithm, rounds)
RUNS = (("tree/fedagrac", "tree", "fedagrac", 2),
        ("tree/fedavg", "tree", "fedavg", 1),
        ("flat/fedagrac", "flat", "fedagrac", 2),
        ("flat/fedavg", "flat", "fedavg", 1))


def _cfg(name):
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    cfg = reduced(get_arch(name), n_layers=2, d_model=128)
    return dataclasses.replace(cfg, vocab=256)


def _whole(t):
    from repro_torch import dist
    return t.full_tensor() if dist.is_dtensor(t) else t


def _rows(spec, t, client_dims=0):
    """A state entry as flat rows (whole): the tree layout's through the
    view table, so both layouts compare as one vector a client."""
    from repro_torch.core import flat
    from repro_torch.launch import specs as specs_lib
    if isinstance(t, torch.Tensor):
        return _whole(t).numpy()
    whole = specs_lib.map_with_path(lambda _p, x: _whole(x), t)
    return flat.ravel(spec, whole, client_dims).numpy()


def _record(out, key, spec, state, losses):
    out[f"{key}/params"] = _rows(spec, state["params"])
    if "nu" in state:
        out[f"{key}/nu"] = _rows(spec, state["nu"])
        out[f"{key}/nu_i"] = _rows(spec, state["nu_i"], 1)
    out[f"{key}/loss"] = np.array(losses)


def main(rank: int, world: int, root: str) -> None:
    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(os.path.join(root, "store"), world),
        rank=rank, world_size=world)
    from repro_torch.checkpoint import serialize
    from repro_torch.configs.base import FedConfig, ShapeConfig
    from repro_torch.core import flat, rounds
    from repro_torch.core.fedopt import get_algorithm
    from repro_torch.launch import specs as specs_lib, train
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 2, device_type="cpu")
    inp = np.load(os.path.join(root, "inputs.npz"))
    cfg = _cfg(ARCH)
    params = serialize.load(os.path.join(root, "weights.msgpack"),
                            specs_lib.abstract_params(cfg), device="cpu")
    tree_spec = flat.make_flat_spec(params)
    batches = {k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")}
    ks = torch.from_numpy(inp["k_steps"])
    weights = torch.from_numpy(inp["weights"])
    m, k_max, b_local, seq = batches["tokens"].shape[1:]
    shape = ShapeConfig("t", seq_len=int(seq), global_batch=int(m * b_local),
                        kind="train")
    lr = float(inp["lr"])
    out, fails, counts = {}, [], {}

    def one(t):
        return {k: v[t] for k, v in batches.items()}

    for key, layout, algo_name, n_rounds in RUNS:
        fed = FedConfig(algorithm=algo_name, lr=lr, param_layout=layout)
        algo = get_algorithm(algo_name, fed)
        step, bundle = train.build_train_round(cfg, shape, mesh, fed,
                                               k_max=int(k_max))
        start = (flat.ravel(bundle["flat_spec"], params)
                 if layout == "flat" else params)
        state = rounds.init_state(start, int(m), algo)
        losses = []
        for t in range(n_rounds):
            state, metrics = step(state, one(t), ks[t], weights)
            losses.append(float(_whole(metrics["loss"])))
        _record(out, key, tree_spec, state, losses)
        counts[key] = _shares(state, bundle["pspecs"]["state"], mesh, key,
                              fails)
        if key != "flat/fedagrac":
            continue
        # three single rounds against a chunk of 2 and its tail of 1
        chunk, _ = train.build_train_round(cfg, shape, mesh, fed,
                                           k_max=int(k_max), chunk_rounds=2)
        for t in range(2, 3):
            state, metrics = step(state, one(t), ks[t], weights)
        single = _whole(state["params"]).numpy()
        state = rounds.init_state(start, int(m), algo)
        state, m1 = chunk(state, {k: v[:2] for k, v in batches.items()},
                          ks[:2], weights.expand(2, -1), [algo.lam] * 2)
        state, m2 = chunk(state, {k: v[2:] for k, v in batches.items()},
                          ks[2:], weights.expand(1, -1), [algo.lam])
        out["chunk/params"] = _whole(state["params"]).numpy()
        out["chunk/single"] = single
        out["chunk/loss"] = np.concatenate([_whole(m1["loss"]).numpy(),
                                            _whole(m2["loss"]).numpy()])

    # the cohort round over a population-sized ν⁽ⁱ⁾ store
    fed = FedConfig(algorithm="fedagrac", lr=lr)
    algo = get_algorithm("fedagrac", fed)
    pop = int(inp["m_population"])
    step, bundle = train.build_population_round(cfg, shape, mesh, fed,
                                                m_population=pop,
                                                k_max=int(k_max))
    state = rounds.init_state(params, pop, algo)
    losses = []
    for t in range(2):
        state, metrics = step(state, one(t), inp["cohorts"][t], ks[t],
                              torch.from_numpy(inp["cweights"][t]))
        losses.append(float(_whole(metrics["loss"])))
    _record(out, "population", tree_spec, state, losses)
    counts["population"] = _shares(state, bundle["pspecs"]["state"], mesh,
                                   "population", fails)
    try:
        train.build_train_round(_cfg(REFUSED), shape, mesh,
                                FedConfig(algorithm="fedagrac"), k_max=2)
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
