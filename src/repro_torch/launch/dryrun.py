"""Multi-pod dry run (``repro.launch.dryrun`` counterpart): every
(architecture × input shape × mesh) step runs once on the production mesh
of a fake world, with no memory and no kernel.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod] [--out results.jsonl]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each step for 256 / 512 XLA host
devices.  Here ``run_combo`` starts a fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once) of 256 or 512 ranks, builds ``make_production_mesh`` on it (CPU
device type), and runs the step through ``launch.train.lower_train`` or
``launch.serve.lower_serve`` on ``FakeTensorMode`` tensors as this
process's rank: the sharding rules, DTensor's propagation and the explicit
regions all run, and the trace counts the FLOPs the rank does, the bytes
its ops move, the collectives by kind with their bytes, the per-rank
bytes of the step's inputs and outputs and the most bytes the rank holds
live at once (``roofline/analysis.py``).  Nothing is allocated.  The
record is the reference's JSONL line, with ``status`` one of ``ok``,
``skipped`` (the reference's long-context rule), ``refused`` (a family
outside the sharded scope: ROADMAP A15), ``over_memory`` (the step ran,
but a rank's peak is over the card's memory: it would not fit) or
``failed`` (a bug).  The fake
backend is started only here, never at import; if it does not import, the
dry run raises.

``--mesh DxM`` runs on a ``(data, model)`` mesh of a fake world of D·M
ranks instead, and ``--reduced`` on the reduced model at a cut shape (the
sequence at most 128, two rows a data slice, one for ``long``), for a
quick check.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Optional

from repro_torch.configs.base import FedConfig
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.configs.shapes import LONG_CONTEXT_OK, SHAPES


def shape_kind(shape_name: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "long"}[shape_name]


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return ("pure full attention at 524k decode — sub-quadratic variants "
                "only (DESIGN.md §4)")
    return None


def fake_world(ranks: int) -> None:
    """This process as rank 0 of a fake process group of ``ranks`` ranks
    (an existing group of another size is ended first)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        if tdist.get_world_size() == ranks:
            return
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=ranks)


def _mesh(multi_pod: bool, variant: str, mesh_shape):
    from repro_torch.launch.mesh import (make_local_mesh,
                                         make_production_mesh,
                                         production_layout)
    if mesh_shape is not None:
        fake_world(mesh_shape[0] * mesh_shape[1])
        return make_local_mesh(*mesh_shape, device_type="cpu")
    shape, _ = production_layout(multi_pod=multi_pod, variant=variant)
    n = 1
    for s in shape:
        n *= s
    fake_world(n)
    return make_production_mesh(multi_pod=multi_pod, variant=variant,
                                device_type="cpu")


def _cut(shape, kind: str, data_slices: int):
    rows = 1 if kind == "long" else 2 * data_slices
    return dataclasses.replace(shape, seq_len=min(shape.seq_len, 128),
                               global_batch=rows)


def run_combo(arch: str, shape_name: str, *, multi_pod: bool,
              k_max: int = 4, algo: str = "fedagrac",
              variant: str = "tp16", mesh_shape=None,
              reduced: bool = False) -> dict:
    from repro_torch.configs.base import reduced as reduced_cfg
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import data_axes, recommended_variant
    from repro_torch.roofline import analysis as roofline

    if mesh_shape is not None:
        mesh_name = f"{mesh_shape[0]}x{mesh_shape[1]}"
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        if variant != "tp16":
            mesh_name += f"/{variant}"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "algo": algo}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    cfg = get_arch(arch)
    cfg = reduced_cfg(cfg) if reduced else specs_lib.bf16_config(cfg)
    shape = SHAPES[shape_name]
    if variant == "auto":
        variant = recommended_variant(cfg)
        rec["mesh"] = mesh_name.split("/")[0] + f"/auto->{variant}"
    kind = shape_kind(shape_name)
    mesh = _mesh(multi_pod, variant, mesh_shape)     # raises without fake_pg
    t0 = time.time()
    try:
        chips = mesh.size()
        if reduced:
            slices = 1
            for a in data_axes(mesh):
                slices *= mesh.size(mesh.mesh_dim_names.index(a))
            shape = _cut(shape, kind, slices)
        if kind == "train":
            fed = FedConfig(algorithm=algo, n_clients=0)    # M from mesh
            trace, bundle = train_lib.lower_train(cfg, shape, mesh, fed,
                                                  k_max=k_max)
            tokens = shape.global_batch * shape.seq_len * k_max
            model_flops = roofline.train_model_flops(cfg, tokens)
        elif kind == "prefill":
            trace, bundle = serve_lib.lower_serve(cfg, shape, mesh,
                                                  kind="prefill")
            model_flops = roofline.prefill_model_flops(
                cfg, shape.global_batch * shape.seq_len)
        else:
            trace, bundle = serve_lib.lower_serve(cfg, shape, mesh,
                                                  kind=kind)
            model_flops = roofline.decode_model_flops(cfg,
                                                      shape.global_batch)
        rec["lower_s"] = round(time.time() - t0, 1)
        rl = roofline.from_trace(trace, chips, model_flops)
        rec["roofline"] = rl.as_dict()
        rec["collective_counts"] = trace["collectives"]["count"]
        rec["memory"] = {"argument_size_in_bytes": trace["in_bytes"],
                         "output_size_in_bytes": trace["out_bytes"],
                         "peak_bytes_per_rank": trace["peak_bytes"]}
        rec["ops"] = trace["ops"]
        rec["status"] = "ok" if roofline.fits(trace) else "over_memory"
        if rec["status"] == "over_memory":
            rec["reason"] = (f"a rank's peak is {trace['peak_bytes'] / 1e9:.1f}"
                             f" GB, over the card's "
                             f"{roofline.HBM_BYTES / 1e9:.0f} GB")
    except Exception as e:
        if isinstance(e, NotImplementedError) and "ROADMAP A15" in str(e):
            rec["status"] = "refused"
            rec["reason"] = str(e)
            return rec
        # any other failure here is a bug in the system
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def _mesh_arg(text: str) -> tuple[int, int]:
    d, m = text.lower().split("x")
    return int(d), int(m)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch, shape) on this mesh")
    ap.add_argument("--k-max", type=int, default=4)
    ap.add_argument("--algo", default="fedagrac")
    ap.add_argument("--mesh-variant", default="tp16",
                    choices=("tp16", "2d", "auto"))
    ap.add_argument("--mesh", type=_mesh_arg, default=None,
                    help="DxM: a (data, model) mesh of a fake world of D·M "
                         "ranks instead of the production mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced model at a cut shape")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    combos = ([(a, s) for a in sorted(ARCHS) for s in SHAPES]
              if args.all else [(args.arch, args.shape)])
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape required (or --all)")

    for arch, shape_name in combos:
        rec = run_combo(arch, shape_name, multi_pod=args.multi_pod,
                        k_max=args.k_max, algo=args.algo,
                        variant=args.mesh_variant, mesh_shape=args.mesh,
                        reduced=args.reduced)
        status = rec["status"]
        extra = ""
        if status in ("ok", "over_memory"):
            rl = rec["roofline"]
            extra = (f" compute={rl['t_compute_s']:.3e}s"
                     f" memory={rl['t_memory_s']:.3e}s"
                     f" coll={rl['t_collective_s']:.3e}s"
                     f" dominant={rl['dominant']}"
                     f" peak={rec['memory']['peak_bytes_per_rank'] / 1e9:.2f}GB")
        elif status == "failed":
            extra = " " + rec["error"]
        if status in ("skipped", "refused", "over_memory"):
            extra += " " + rec["reason"]
        print(f"[{status:7s}] {arch:24s} {shape_name:12s} "
              f"{rec['mesh']:8s}{extra}", flush=True)
        if rec.get("traceback") and not args.out:
            print(rec["traceback"])
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
