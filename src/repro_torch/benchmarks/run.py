"""Benchmark aggregator of the port's paper-experiment twins (the
counterpart of ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] \\
        [--only NAME[,NAME…]] [--device cpu]

Each module prints CSV rows in its reference module's columns; the claim it
validates is in its docstring.  Every module runs on the card unless
``--device`` says otherwise; a module that fails makes the run exit
non-zero.  The reference's other modules have no twin yet (ROADMAP A17).
"""
from __future__ import annotations

import argparse
import time
import traceback

from repro_torch.benchmarks import (compression_bench, engine_bench,
                                    fairness, fig2_lambda, fig3_orientation,
                                    fig4_grid, fig5_curves, robust_bench,
                                    scenario_bench, server_opt,
                                    serving_bench, table1_deterioration,
                                    table2_utilization,
                                    table6_rounds, table_async,
                                    thm1_quadratic)

MODULES = {
    "thm1": thm1_quadratic,
    "table1": table1_deterioration,
    "table2": table2_utilization,
    "fig2": fig2_lambda,
    "fig3": fig3_orientation,
    "fig4": fig4_grid,
    "table6": table6_rounds,
    "table_async": table_async,
    "fig5": fig5_curves,
    "compression": compression_bench,
    "scenario": scenario_bench,
    "robust": robust_bench,
    "fairness": fairness,
    "server_opt": server_opt,
    "engine": engine_bench,
    "serving": serving_bench,
}


def parse_only(only: str | None) -> list[str]:
    """Validate ``--only``: whitespace-tolerant, order-preserving dedup, and
    a fail-fast error naming every valid module for any unknown (or empty)
    selection — never a silent no-op run.  A module's file name
    (``compression_bench``) selects it too."""
    if only is None:
        return list(MODULES)
    by_file = {mod.__name__.rsplit(".", 1)[1]: key
               for key, mod in MODULES.items()}
    names = [by_file.get(n.strip(), n.strip()) for n in only.split(",")
             if n.strip()]
    names = list(dict.fromkeys(names))
    unknown = [n for n in names if n not in MODULES]
    if unknown or not names:
        what = (f"unknown module(s) {unknown}" if unknown
                else f"--only {only!r} selects nothing")
        raise SystemExit(f"error: {what}; choose from {sorted(MODULES)}")
    return names


def main(argv: list | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="reduced rounds/grids (CI budget)")
    ap.add_argument("--only", default=None, metavar="NAME[,NAME…]",
                    help=f"comma-separated subset of {sorted(MODULES)}")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    names = parse_only(args.only)
    failures = []
    for name in names:
        mod = MODULES[name]
        print(f"\n# ===== {name}: {mod.__doc__.strip().splitlines()[0]}")
        t0 = time.time()
        try:
            mod.main(quick=args.quick, device=args.device)
            print(f"# {name} done in {time.time() - t0:.1f}s")
        except Exception:
            failures.append(name)
            print(f"# {name} FAILED")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
