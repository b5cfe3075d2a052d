"""The reference's ``--quick`` rows of the paper experiments, as committed
in ``src/repro_torch/benchmarks/reference_quick.json``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_reference_quick.py

regenerates the file from the JAX modules (``benchmarks/``, about a minute
on the CPU); tests/test_torch_benchmarks.py regenerates part of it and
holds it equal to the committed file.  Each module's rows are kept as its
``main(quick=True)`` prints them (a header, then one row a line, each cell
a string).  Lines that start with ``#`` (a module's closing notes, such as
table_async's drift check) are kept apart under ``notes``.  Rows that
report rounds (or updates) to a target also keep ``target_margin``: the
least |accuracy − target| over the evaluations up to the crossing (every
one where the target is never reached), so a check of the port's rounds
knows where the reference sat within rounding of the target (the scenario
and robust modules have no such helper: their ``History.rounds_to_target``
calls are recorded, one a run, the ν-ablation runs after the rows).  The
compression, scenario and robust modules run with its JSON report written to a temporary
directory, not over the repository's ``BENCH_*.json``.  The
card has no JAX: this file is how ``chip_smoke.py`` holds the card to the
reference.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "benchmarks" / "reference_quick.json"
MODULES = {"thm1": "thm1_quadratic", "table1": "table1_deterioration",
           "table2": "table2_utilization", "fig2": "fig2_lambda",
           "fig3": "fig3_orientation", "fig4": "fig4_grid",
           "fairness": "fairness", "server_opt": "server_opt",
           "table_async": "table_async", "compression": "compression_bench",
           "scenario": "scenario_bench", "robust": "robust_bench"}
# modules without a rounds-to-target helper whose runs' History calls are
# recorded instead
RECORD_HISTORY = ("scenario", "robust")
COMMAND = ("PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks.run "
           "--quick --only " + ",".join(MODULES))


def module_rows(name: str) -> dict:
    """One reference module's quick rows as it prints them."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    mod = importlib.import_module(f"benchmarks.{MODULES[name]}")
    margins = []
    # the module's rounds-to-target helper: ``rounds_to(hist, target)``,
    # or table_async's ``_to_target(hist, sim_times)``
    hook = next((h for h in ("rounds_to", "_to_target") if hasattr(mod, h)),
                None)
    helper = getattr(mod, hook) if hook else None

    def recording(hist, *args):
        target = args[0] if hook == "rounds_to" else mod.TARGET
        r = hist.rounds_to_target(target)
        seen = hist.metric[:r] if r is not None else hist.metric
        margins.append(min(abs(v - target) for v in seen))
        return helper(hist, *args)

    # without a module helper, the History method itself records
    # (RECORD_HISTORY's modules)
    from repro.fed.simulation import History
    to_target = History.rounds_to_target

    def recording_method(hist, target, *args, **kw):
        r = to_target(hist, target, *args, **kw)
        seen = hist.metric[:r] if r is not None else hist.metric
        margins.append(min(abs(v - target) for v in seen))
        return r

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        root = getattr(mod, "ROOT", None)
        try:
            if hook:
                setattr(mod, hook, recording)
            elif name in RECORD_HISTORY:
                History.rounds_to_target = recording_method
            if root is not None:
                mod.ROOT = Path(tmp)
            with contextlib.redirect_stdout(buf):
                mod.main(quick=True)
        finally:
            if hook:
                setattr(mod, hook, helper)
            History.rounds_to_target = to_target
            if root is not None:
                mod.ROOT = root
    lines = buf.getvalue().strip().splitlines()
    header, *rows = [line.split(",") for line in lines
                     if not line.startswith("#")]
    out = {"header": header, "rows": rows}
    notes = [line for line in lines if line.startswith("#")
             and not line.startswith("# wrote")]
    if notes:
        out["notes"] = notes
    if margins:
        out["target_margin"] = margins
    return out


def generate(names=tuple(MODULES)) -> dict:
    return {"command": COMMAND,
            "modules": {name: module_rows(name) for name in names}}


if __name__ == "__main__":
    OUT.write_text(json.dumps(generate(), indent=1) + "\n")
    print(f"wrote {OUT}")
