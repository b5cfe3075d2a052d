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
reference.  ``examples`` carries the reference examples' tables
(``EXAMPLES``) and ``cohorts`` the reference's cohorts of the settings the
card draws (``COHORTS``).
"""
from __future__ import annotations

import contextlib
import importlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "benchmarks" / "reference_quick.json"
MODULES = {"thm1": "thm1_quadratic", "table1": "table1_deterioration",
           "table2": "table2_utilization", "fig2": "fig2_lambda",
           "fig3": "fig3_orientation", "fig4": "fig4_grid",
           "fairness": "fairness", "server_opt": "server_opt",
           "table_async": "table_async", "compression": "compression_bench",
           "scenario": "scenario_bench", "robust": "robust_bench",
           "int8_nu": "ablation_int8_nu"}
# modules without a rounds-to-target helper whose runs' History calls are
# recorded instead
RECORD_HISTORY = ("scenario", "robust", "int8_nu")
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


# the reference's examples the card is held to, and their rows' columns
EXAMPLES = {"failure_scenarios": "examples/failure_scenarios.py"}
# cohorts the card is held to: (name, M, C, sampler, seed, availability,
# rounds); weights are the data mass of the setting's partition
COHORTS = (
    # chip_smoke phase 11 (b): the partial_participation example's task
    ("partial_participation", 256, 8, "uniform", 0, 0.7, 5),
    ("partial_participation", 256, 8, "round_robin", 0, 0.7, 5),
    ("partial_participation", 256, 8, "weighted", 0, 0.7, 5),
    ("partial_participation", 256, 8, "availability", 0, 0.7, 5),
    # chip_smoke phase 15 (a): population_bench's largest M
    ("population_bench", 100_000, 8, "uniform", 0, 1.0, 48))


def example_rows(name: str) -> dict:
    """A reference example's table as its ``main()`` prints it: the header
    and the rows of the lines before its closing text, split on spaces."""
    import runpy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / EXAMPLES[name]), run_name="__main__")
    lines = buf.getvalue().split("\n\n")[0].strip().splitlines()
    header, *rows = [line.split() for line in lines]
    return {"header": header, "rows": rows}


def cohort_rows() -> list:
    """Each ``COHORTS`` setting's reference cohorts, one list a round."""
    import jax
    from repro.data import fedprox_synthetic
    from repro.fed.population import ClientPopulation
    out = []
    weights_of = {}
    for name, m, c, sampler, seed, avail, rounds in COHORTS:
        if name == "partial_participation" and name not in weights_of:
            _, parts = fedprox_synthetic(jax.random.PRNGKey(0), m,
                                         alpha=1.0, beta=1.0,
                                         n_per_client=50)
            sizes = np.array([len(p) for p in parts], np.float64)
            weights_of[name] = sizes / sizes.sum()
        weights = weights_of.get(name)
        pop = ClientPopulation(m, cohort_size=c, sampler=sampler, seed=seed,
                               weights=weights, availability=avail)
        out.append({"setting": name, "m": m, "cohort": c,
                    "sampler": sampler, "seed": seed, "availability": avail,
                    "ids": [np.asarray(pop.host_cohort(t)[0]).tolist()
                            for t in range(rounds)]})
    return out


def generate(names=tuple(MODULES)) -> dict:
    return {"command": COMMAND,
            "modules": {name: module_rows(name) for name in names},
            "examples": {name: example_rows(name) for name in EXAMPLES},
            "cohorts": cohort_rows()}


if __name__ == "__main__":
    OUT.write_text(json.dumps(generate(), indent=1) + "\n")
    print(f"wrote {OUT}")
