"""The failure-scenario survival twin
(``repro_torch.benchmarks.scenario_bench``) at its full ``--quick`` size
on the CPU: every row equal to the reference's committed quick row
(``reference_quick.json``, regenerated from the JAX module by
tests/_reference_quick.py) — the printed accuracies, updates to target,
simulated seconds and abort fractions alike.  The scenarios draw the
reference's keyed streams (fed/keyed.py), so the timelines and k′ rows
are the reference's, and the rest of each run is the same computation in
other float32 roundings, which the printed 4 decimals do not see.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.benchmarks import scenario_bench  # noqa: E402

REFERENCE = json.loads(Path(scenario_bench.__file__).with_name(
    "reference_quick.json").read_text())["modules"]["scenario"]


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


def test_scenario_twin_quick_rows_equal_reference(capsys):
    scenario_bench.main(quick=True, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if not ln.startswith("#")]
    header, *rows = [ln.split(",") for ln in lines]
    assert header == REFERENCE["header"]
    assert rows == REFERENCE["rows"]
