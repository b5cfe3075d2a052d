"""The attack × defense twin (``repro_torch.benchmarks.robust_bench``)
at its full ``--quick`` size on the CPU: every row equal to the
reference's committed quick row (``reference_quick.json``, regenerated
from the JAX module by tests/_reference_quick.py) — the printed
accuracies, rounds to target, survival and quarantine counts alike.  The
attacks draw the reference's keyed streams (fed/keyed.py), so the
corrupt sets are the reference's, and the rest of each run is the same
computation in other float32 roundings, which the printed 4 decimals do
not see.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.benchmarks import robust_bench  # noqa: E402

REFERENCE = json.loads(Path(robust_bench.__file__).with_name(
    "reference_quick.json").read_text())["modules"]["robust"]


from _torch_one_thread import _one_cpu_thread  # noqa: E402,F401


def test_robust_twin_quick_rows_equal_reference(capsys):
    robust_bench.main(quick=True, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
             if not ln.startswith("#")]
    header, *rows = [ln.split(",") for ln in lines]
    assert header == REFERENCE["header"]
    assert rows == REFERENCE["rows"]
