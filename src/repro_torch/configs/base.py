"""Federated round configuration — the port's copy of ``repro``'s
``FedConfig``, with the same field names and defaults so one config reads
the same in both packages.

The port runs the flat-layout synchronous round.  Fields whose features are
not ported yet keep their defaults here and make the port's
``FederatedSimulation`` raise ``NotImplementedError`` when set (it names the
ROADMAP item that brings them).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """FedaGrac / baseline round configuration."""
    algorithm: str = "fedagrac"            # fedavg|fednova|scaffold|fedprox|fedlin|fedagrac[_avg/_first/_reverse]
    n_clients: int = 16
    k_mean: int = 4                        # local steps per round (mean)
    k_var: float = 0.0                     # Gaussian variance of K_i (paper §6.1)
    k_mode: Literal["fixed", "random"] = "fixed"
    lr: float = 0.05
    calibration_rate: float = 0.05         # λ
    prox_mu: float = 0.1                   # FedProx regularizer
    weights: Literal["uniform", "data"] = "uniform"
    server_opt: Literal["sgd", "momentum", "adam"] = "sgd"
    server_lr: float = 1.0                 # FedOpt server step size
    seed: int = 0
    # -- buffered semi-asynchronous execution (not ported: ROADMAP A7) ------
    buffer_size: int = 0
    staleness: Literal["constant", "hinge", "poly"] = "constant"
    staleness_a: float = 0.5
    staleness_b: int = 4
    speed_dist: Literal["fixed", "uniform", "lognormal", "bimodal"] = "lognormal"
    speed_sigma: float = 0.5
    comm_latency: float = 0.0
    # -- partial participation (not ported: ROADMAP A6) ---------------------
    cohort_size: int = 0
    cohort_sampler: Literal["all", "uniform", "weighted", "availability",
                            "round_robin"] = "all"
    availability: float = 1.0
    cohort_nu_decay: float = 0.0
    # -- parameter layout: the port runs "flat" only (tree: ROADMAP A2) -----
    param_layout: Literal["tree", "flat"] = "tree"
    master_dtype: Literal["", "float32", "bfloat16", "float16"] = ""
    # -- failure scenarios (not ported: ROADMAP A8) -------------------------
    scenario: str = "baseline"
    dropout_rate: float = 0.1
    scenario_rate: float = 0.1
    scenario_magnitude: float = 10.0
    scenario_period: float = 64.0
    rejoin_delay: float = 0.0
    # -- wire compression (core/compress.py; flat synchronous round) -------
    compressor: str = "none"
    broadcast_compressor: str = "none"
    error_feedback: bool = True
    topk_frac: float = 0.05
    quantize_transmit: bool = False
    # -- Byzantine-robust aggregation (not ported: ROADMAP A10) -------------
    defense: str = "none"
    defense_clip: float = 0.0
    trim_frac: float = 0.2
    krum_f: int = 1
    nu_defense: bool = True
    quarantine_window: int = 0
    quarantine_z: float = 4.0
    quarantine_nonfinite: int = 1

    def __post_init__(self):
        """Fail at construction on an unknown name, listing the valid ones
        (the registries are imported lazily: they live downstream).  The
        deprecated ``quantize_transmit=True`` folds into
        ``compressor="int8"``, as in the reference."""
        import warnings

        from repro_torch.core.compress import COMPRESSORS
        from repro_torch.core.fedopt import ALGORITHMS
        from repro_torch.core.stages import SERVER_OPTIMIZERS

        def _check(field: str, value, valid) -> None:
            if value not in valid:
                raise ValueError(f"unknown {field} {value!r}; valid "
                                 f"options: {sorted(valid)}")

        if self.quantize_transmit:
            warnings.warn(
                "FedConfig.quantize_transmit is deprecated; use "
                "compressor='int8' (delta + ν compression with error "
                "feedback, core/compress.py)", DeprecationWarning,
                stacklevel=2)
            if self.compressor == "none":
                object.__setattr__(self, "compressor", "int8")
        _check("compressor", self.compressor, COMPRESSORS)
        _check("broadcast_compressor", self.broadcast_compressor,
               COMPRESSORS)
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac {self.topk_frac} not in (0, 1]")

        _check("algorithm", self.algorithm, ALGORITHMS)
        _check("server_opt", self.server_opt, SERVER_OPTIMIZERS)
        _check("weights", self.weights, ("uniform", "data"))
        _check("k_mode", self.k_mode, ("fixed", "random"))
        _check("param_layout", self.param_layout, ("tree", "flat"))
