"""How far float32 rounding alone moves the paper's CNN run that
``chip_smoke.py`` phase 11 (c) holds the card to, and how often its
spread rule would refuse a run that differs from the plain one only in
rounding.

    PYTHONPATH=src python -m repro_torch.roofline.cnn_spread --reruns 160

Runs the phase's CNN task (``chip_smoke.py``'s settings and run, imported
from the checkout) on the CPU once plainly, then ``--reruns`` times with
only float32 rounding changed, in the order the phase draws them:
reversed rows, then the initial weights moved one ulp (seeds 1, 2, ...).
Prints one JSON line per algorithm: the branches the reruns landed on
(the params' max abs difference from the plain run, the last round's loss
difference and the eval accuracy difference in samples, each rounded to
two digits, with their counts), and for each cap in ``--caps`` the share
of reruns that the phase's rule (``chip_smoke._vs_cpu_margins``) refuses
when each is held, as the card is, against that many others drawn at
random (``--draws`` draws each).  Needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch


def _stand_in(run: dict, plain: dict, pmax: float) -> dict:
    """The rule reads a run's params only through their max abs difference
    from the plain run's and the plain run's max abs value: a two-element
    tensor carries both."""
    d = float((run["params"] - plain["params"]).abs().max())
    return {"loss": run["loss"], "metric": run["metric"],
            "params": torch.tensor([d, pmax], dtype=torch.float64)}


def _branch(run: dict, plain: dict, n_eval: int) -> tuple:
    return (float(f"{float(run['params'][0]):.2g}"),
            float(f"{abs(run['loss'][-1] - plain['loss'][-1]):.2g}"),
            round(float(n_eval * np.max(np.abs(run["metric"]
                                               - plain["metric"])))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reruns", type=int, default=160)
    ap.add_argument("--algorithm", action="append",
                    choices=("fedagrac", "fedavg"))
    ap.add_argument("--caps", type=int, nargs="+", default=[3, 32, 64, 128])
    ap.add_argument("--draws", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
    import chip_smoke as smoke
    from repro_torch.data import dirichlet_partition, image_classification
    from repro_torch.models.simple import cnn_init

    cnn = smoke.CNN
    data = image_classification(torch.Generator().manual_seed(0),
                                cnn["samples"])
    parts = dirichlet_partition(data.y.numpy(), cnn["clients"],
                                cnn["alpha"], seed=0)
    params0 = cnn_init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(args.seed)
    for algorithm in args.algorithm or cnn["algorithms"]:
        plain = smoke._run_cnn("cpu", algorithm, data, parts, params0)
        pmax = float(plain["params"].abs().max())
        base = {"loss": plain["loss"], "metric": plain["metric"],
                "params": torch.tensor([0.0, pmax], dtype=torch.float64)}
        runs = [_stand_in(smoke._run_cnn("cpu", algorithm, data, parts,
                                         params0, True), plain, pmax)]
        runs += [_stand_in(smoke._run_cnn("cpu", algorithm, data, parts,
                                          smoke._ulp_moved(params0, s)),
                           plain, pmax)
                 for s in range(1, args.reruns)]
        branches = Counter(_branch(r, plain, cnn["samples"]) for r in runs)
        refused = {}
        for cap in args.caps:
            n = min(cap, len(runs) - 1)
            bad = 0
            for j, run in enumerate(runs):
                others = np.delete(np.arange(len(runs)), j)
                for _ in range(args.draws):
                    probes = [runs[k] for k in
                              rng.choice(others, n, replace=False)]
                    bad += not smoke._vs_covered(smoke._vs_cpu_margins(
                        run, base, probes, cnn["samples"]))
            refused[str(cap)] = bad / (len(runs) * args.draws)
        print(json.dumps({
            "algorithm": algorithm, "reruns": len(runs),
            "plain_loss": plain["loss"].tolist(),
            "plain_metric": plain["metric"].tolist(),
            "branches": [{"params": k[0], "last_loss": k[1],
                          "metric_samples": k[2], "count": v}
                         for k, v in branches.most_common()],
            "refused_share_by_cap": refused}), flush=True)


if __name__ == "__main__":
    main()
