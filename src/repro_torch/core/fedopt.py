"""Federated optimizer zoo.

Every algorithm names a composition of the four round-engine stages
(core/stages.py — client update, aggregation, orientation, server
optimizer; DESIGN.md §2):

    local step   : x ← x − η (g + λ·(ν − ν⁽ⁱ⁾) [+ μ_prox (x − x̃_t)])
    aggregation  : weighted average (or FedNova normalized average)
    orientation  : what each client contributes to the next global ν

======================  λ    strategy    prox   normalize
FedAvg                  0    —           —      —
FedProx                 0    —           μ      —
FedNova                 0    —           —      yes
SCAFFOLD (=_avg)        1    avg         —      —
FedLin (approx.)        1    first       —      —
FedaGrac                λ    fedagrac    —      —
FedaGrac_first          λ    first       —      —
FedaGrac_reverse        λ    reverse     —      —

``strategy`` picks the transmitted gradient per client (paper §4.2):
fedagrac = fast clients (K_i > K̄) send the *first* stochastic gradient,
slow clients send the *averaged* gradient; ``reverse`` swaps them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FedConfig


@dataclasses.dataclass(frozen=True)
class Algorithm:
    name: str
    lam: float = 0.0               # calibration rate λ
    strategy: str = "none"         # none|avg|first|fedagrac|reverse
    prox_mu: float = 0.0
    normalize: bool = False        # FedNova-style normalized aggregation
    # FedOpt-style server optimizer (Reddi et al. 2021) applied to the
    # round pseudo-gradient Δ = x̃_t − Σ ω_i x_i: "sgd" (plain averaging),
    # "momentum" (FedAvgM) or "adam" (FedAdam).  Composes with every
    # client rule above — a beyond-paper extension (EXPERIMENTS.md).
    server_opt: str = "sgd"
    server_lr: float = 1.0
    server_beta1: float = 0.9

    @property
    def uses_nu(self) -> bool:
        return self.strategy != "none"

    # -- stage composition (core/stages.py registries, DESIGN.md §2) --------
    @property
    def aggregator(self) -> str:
        """Key into stages.AGGREGATORS / stages.BUFFERED_AGGREGATORS."""
        return "fednova" if self.normalize else "mean"

    @property
    def selector(self) -> str:
        """Key into stages.SELECTORS (orientation transmit choice)."""
        return self.strategy


def get_algorithm(name: str, fed: FedConfig) -> Algorithm:
    lam = fed.calibration_rate
    server = dict(server_opt=fed.server_opt, server_lr=fed.server_lr)
    table = {
        "fedavg": Algorithm("fedavg", **server),
        "fedprox": Algorithm("fedprox", prox_mu=fed.prox_mu, **server),
        "fednova": Algorithm("fednova", normalize=True, **server),
        "scaffold": Algorithm("scaffold", lam=1.0, strategy="avg", **server),
        "fedlin": Algorithm("fedlin", lam=1.0, strategy="first", **server),
        "fedagrac": Algorithm("fedagrac", lam=lam, strategy="fedagrac", **server),
        "fedagrac_avg": Algorithm("fedagrac_avg", lam=lam, strategy="avg", **server),
        "fedagrac_first": Algorithm("fedagrac_first", lam=lam,
                                    strategy="first", **server),
        "fedagrac_reverse": Algorithm("fedagrac_reverse", lam=lam,
                                      strategy="reverse", **server),
    }
    if name not in table:
        raise KeyError(f"unknown algorithm {name!r}; available: {sorted(table)}")
    return table[name]


ALGORITHMS = ("fedavg", "fedprox", "fednova", "scaffold", "fedlin",
              "fedagrac", "fedagrac_avg", "fedagrac_first", "fedagrac_reverse")
