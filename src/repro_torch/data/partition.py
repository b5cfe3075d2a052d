"""Non-IID client partitioning — the paper's DP1 (Dirichlet) and DP2
(label sharding) schemes, the IID split, and the Gaussian K_i schedule
(§6.1).  Numpy only, copied from ``repro.data.partition``: the same
arguments give the same index arrays, bit for bit."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, m: int, alpha: float = 0.3,
                        seed: int = 0) -> list[np.ndarray]:
    """DP1: split indices across ``m`` clients via per-class Dirichlet(α)
    proportions.  Smaller α ⇒ more heterogeneous.  A client the draw
    leaves empty gets one random sample."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    idx_by_client: list[list[int]] = [[] for _ in range(m)]
    for c in np.unique(labels):
        idx_c = np.flatnonzero(labels == c)
        rng.shuffle(idx_c)
        props = rng.dirichlet(np.full(m, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx_c)).astype(int)
        for i, part in enumerate(np.split(idx_c, cuts)):
            idx_by_client[i].extend(part.tolist())
    out = []
    for parts in idx_by_client:
        arr = np.array(sorted(parts), dtype=np.int64)
        if arr.size == 0:
            arr = np.array([int(rng.integers(len(labels)))], dtype=np.int64)
        out.append(arr)
    return out


def shard_partition(labels: np.ndarray, m: int, classes_per_client: int = 5,
                    seed: int = 0) -> list[np.ndarray]:
    """DP2: label-sorted sharding (McMahan-style).  Indices are sorted by
    label and split into ``m × classes_per_client`` contiguous shards; each
    client receives ``classes_per_client`` random shards — equal data
    volume, ≈``classes_per_client`` labels each."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_shards = m * classes_per_client
    order = np.lexsort((rng.permutation(len(labels)), labels))
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    return [np.sort(np.concatenate(
        [shards[perm[i * classes_per_client + j]]
         for j in range(classes_per_client)])).astype(np.int64)
        for i in range(m)]


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
