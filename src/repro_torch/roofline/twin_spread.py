"""How far float32 rounding alone moves the mlp runs of the paper twins
that ``chip_smoke.py`` phase 12 holds the card to (table1's mlp rows and
fig2, at their ``--quick`` size), and how often its spread rule would
refuse a run that differs from the plain one only in rounding.

    PYTHONPATH=src python -m repro_torch.roofline.twin_spread --reruns 24

Runs each twin on the CPU once plainly (through its ``main``, recorded by
``chip_smoke._RecordedRuns``), then reruns every mlp run with only float32
rounding changed, as the phase draws them: its rows reversed, then
``--reruns`` relabellings of the model's input features and hidden units
(seeds 1, 2, ...; ``chip_smoke._cpu_rerun``).  Prints one JSON line per
run: the largest loss difference from the plain run of each rerun
(rounded to two digits, with their counts), and for each cap in
``--caps`` the share of relabelled reruns that the phase's rule
(``chip_smoke._vs_cpu_margins``) refuses when each is held, as the card
is, against the reversed rerun and then the others in seed order until it
is covered or the cap is reached.  Needs no card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch


def _refused(card: dict, plain: dict, probes: list, cap: int,
             smoke) -> bool:
    """Does the phase's rule refuse ``card``, drawing from ``probes`` in
    order (the reversed rerun first) until it is covered or ``cap``?"""
    drawn = []
    for probe in probes:
        drawn.append(probe)
        if smoke._vs_covered(smoke._vs_cpu_margins(card, plain, drawn,
                                                   smoke.TWIN_EVAL)):
            return False
        if len(drawn) >= cap:
            break
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reruns", type=int, default=24)
    ap.add_argument("--caps", type=int, nargs="+", default=[1, 8, 16, 32])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
    import chip_smoke as smoke
    from repro_torch.benchmarks.run import MODULES
    for name in ("table1", "fig2"):
        with smoke._RecordedRuns() as runs, \
                contextlib.redirect_stdout(io.StringIO()):
            MODULES[name].main(quick=True, device="cpu")
        for i, rec in enumerate(runs):
            if rec["sim"]._loss_fn.__name__ != "mlp_loss":
                continue
            t0 = time.perf_counter()
            hist = rec["hist"]
            plain = {"loss": np.array(hist.loss),
                     "metric": np.array(hist.metric),
                     "params": rec["params"]}
            batch = rec["sim"].batcher.batch_size
            reversed_rows = smoke._cpu_rerun(
                rec, torch.arange(batch - 1, -1, -1))
            relabelled = [smoke._cpu_rerun(rec, relabel_seed=s)
                          for s in range(1, args.reruns + 1)]
            refused = {
                cap: float(np.mean([
                    _refused(card, plain, [reversed_rows] + relabelled[:j]
                             + relabelled[j + 1:], cap, smoke)
                    for j, card in enumerate(relabelled)]))
                for cap in args.caps}
            spread = Counter(
                float(f"{np.max(np.abs(r['loss'] - plain['loss'])):.2g}")
                for r in [reversed_rows] + relabelled)
            print(json.dumps({
                "module": name, "run": i,
                "algorithm": rec["sim"].fed.algorithm,
                "rounds": rec["rounds"], "k_max": rec["sim"].k_max,
                "reruns": args.reruns,
                "max_loss_diff": sorted(spread.items()),
                "refused_share": refused,
                "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
