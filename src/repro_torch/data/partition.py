"""Client partitioning and the Gaussian K_i schedule (§6.1) — numpy only,
copied from ``repro.data.partition``."""
from __future__ import annotations

import numpy as np


def iid_partition(n: int, m: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p).astype(np.int64) for p in np.array_split(perm, m)]


def gaussian_k_schedule(m: int, mean: int, var: float, t_rounds: int,
                        mode: str = "fixed", k_min: int = 1,
                        seed: int = 0) -> np.ndarray:
    """K_i schedule (paper §6.1): Gaussian(mean, var), clipped at ``k_min``.

    Returns (t_rounds, m) int32.  ``fixed``: one draw reused every round;
    ``random``: re-drawn per round."""
    rng = np.random.default_rng(seed)
    if mode == "fixed":
        k = np.maximum(rng.normal(mean, np.sqrt(var), m).round(), k_min)
        ks = np.tile(k[None, :], (t_rounds, 1))
    elif mode == "random":
        ks = np.maximum(rng.normal(mean, np.sqrt(var), (t_rounds, m)).round(),
                        k_min)
    else:
        raise ValueError(mode)
    return ks.astype(np.int32)
