"""Client population: partial participation and cohort sampling
(``repro.fed.population`` counterpart, its synchronous part).

The server keeps per-client metadata (data mass ω_i, availability) for the
whole population of M clients while each round runs only a sampled
**cohort** of C ≤ M clients.  Samplers are pluggable through ``SAMPLERS``
(name → draw function).

The draws run on the host.  ``torch.Generator`` cannot reproduce
``jax.random``, so each round's randomness comes from the numpy stream
``default_rng((seed, t, COHORT_STREAM))``: a cohort is a pure function of
``(seed, t)``, the same whatever device the round runs on, and a run on the
card sees the cohorts of the same run on the CPU.  The uniform draw is the
reference's O(C) keyed permutation (Feistel + cycle-walking) with its round
keys taken from that stream; given the same round keys its arithmetic is
the reference's, bit for bit, in numpy ``uint32`` (whose products wrap).
The weighted and availability draws are O(M) host work per round.

Weight renormalization (the unbiasedness rule): cohort aggregation runs in
pseudo-delta form  x ← x + Σ_{i∈S} w̃_i (x⁽ⁱ⁾ − x), and ``cohort_weights``
picks w̃ per sampler so the update estimates the full-participation
direction Σ ω_i (x⁽ⁱ⁾ − x) without bias:

    all           w̃_i = ω_i                 (Σ w̃ = 1: the exact round)
    uniform       w̃_i = ω_i · M/C           (Horvitz–Thompson, π_i = C/M)
    round_robin   w̃_i = ω_i · M/C           (exact over every M/C rounds)
    weighted      w̃_i = 1/C                 (draws ∝ ω_i with replacement)
    availability  w̃_i = ω_i / Σ_{j∈S} ω_j   (self-normalized; biased toward
                                             available clients by design)

The asynchronous dispatch hooks (``report_weights``, ``initial_dispatch``,
``pick_dispatch``) come with the buffered engine (ROADMAP A7).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

# the third word of a cohort draw's numpy key: client i's batch stream is
# keyed (seed, t, i), and no client id reaches 2³² − 1
COHORT_STREAM = 2 ** 32 - 1


# ---------------------------------------------------------------------------
# sampler registry — fn(pop, rng, t) -> (C,) int32 client ids
# ---------------------------------------------------------------------------

def _sample_all(pop: "ClientPopulation", rng: np.random.Generator,
                t: int) -> np.ndarray:
    return np.arange(pop.m, dtype=np.int32)


def _mix(x: np.ndarray, k) -> np.ndarray:
    """murmur3-style uint32 finalizer — the Feistel round function."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ np.uint32(k)) * np.uint32(0x9E3779B9)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _permutation_points(round_keys: np.ndarray, m: int, points: np.ndarray
                        ) -> np.ndarray:
    """Evaluate a keyed pseudorandom permutation of [0, m) at ``points`` —
    O(|points|), never materializing the M-sized domain.

    A 4-round Feistel network over 2·half bits, keyed by the 4 uint32
    ``round_keys``, is a bijection of [0, 2^{2·half}) ⊇ [0, m); cycle-walking
    (re-encrypt while the image lands past m) restricts it to [0, m).
    Walking from a point < m ends: the point's own cycle contains it."""
    half = (max((m - 1).bit_length(), 2) + 1) // 2
    shift = np.uint32(half)
    mask = np.uint32((1 << half) - 1)
    rks = np.asarray(round_keys, np.uint32)

    def enc(v):
        left, right = v >> shift, v & mask
        for i in range(4):
            left, right = right, left ^ (_mix(right, rks[i]) & mask)
        return (left << shift) | right

    v = enc(np.atleast_1d(np.asarray(points, np.uint32)))
    out = v >= m
    while out.any():
        v[out] = enc(v[out])
        out = v >= m
    return v.astype(np.int32)


def _sample_uniform(pop: "ClientPopulation", rng: np.random.Generator,
                    t: int) -> np.ndarray:
    """Uniform WITHOUT replacement in O(C): a keyed pseudorandom
    permutation of [0, M) evaluated at points 0…C-1 — distinct by
    bijectivity, and never touching M elements."""
    round_keys = rng.integers(0, 2 ** 32, 4, dtype=np.uint32)
    return _permutation_points(round_keys, pop.m,
                               np.arange(pop.cohort_size, dtype=np.uint32))


def _sample_weighted(pop: "ClientPopulation", rng: np.random.Generator,
                     t: int) -> np.ndarray:
    """Weight-proportional WITH replacement (p = ω): aggregate with uniform
    1/C weights.  An id can come out more than once."""
    return rng.choice(pop.m, pop.cohort_size, replace=True,
                      p=pop._p).astype(np.int32)


def _sample_availability(pop: "ClientPopulation", rng: np.random.Generator,
                         t: int) -> np.ndarray:
    """Client i is up this round w.p. availability_i; the cohort is a
    uniform draw among available clients, by Gumbel scores, largest first.
    Unavailable clients fill the cohort only when fewer than C are up:
    their scores are pushed below every available client's."""
    up = rng.random(pop.m) < pop.availability
    score = rng.gumbel(size=pop.m) + np.where(up, 0.0, -1e9)
    top = np.argpartition(-score, pop.cohort_size - 1)[:pop.cohort_size]
    return top[np.argsort(-score[top], kind="stable")].astype(np.int32)


def _sample_round_robin(pop: "ClientPopulation", rng: np.random.Generator,
                        t: int) -> np.ndarray:
    """Deterministic cyclic blocks: round t runs clients [tC, tC + C) mod M
    — every client exactly once per M/C rounds when C divides M."""
    return ((t * pop.cohort_size + np.arange(pop.cohort_size)) % pop.m
            ).astype(np.int32)


SAMPLERS: dict[str, Callable] = {
    "all": _sample_all,
    "uniform": _sample_uniform,
    "weighted": _sample_weighted,
    "availability": _sample_availability,
    "round_robin": _sample_round_robin,
}


class ClientPopulation:
    """Per-client metadata + the cohort draw for a population of M clients.

    ``weights`` is the data mass ω (normalized to sum 1, float32 as in the
    reference), ``availability`` the per-client up-probability the
    ``availability`` sampler uses.  Scalars broadcast to (M,).  Draws and
    weights are numpy arrays on the host."""

    def __init__(self, m: int, *, cohort_size: Optional[int] = None,
                 sampler: str = "uniform", seed: int = 0, weights=None,
                 availability=1.0):
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; available: "
                             f"{sorted(SAMPLERS)}")
        self.m = int(m)
        self.cohort_size = int(cohort_size) if cohort_size else self.m
        if not 1 <= self.cohort_size <= self.m:
            raise ValueError(
                f"cohort_size {self.cohort_size} not in [1, {self.m}]")
        if sampler == "all" and self.cohort_size != self.m:
            raise ValueError(
                f"sampler='all' requires C == M (got C={self.cohort_size}, "
                f"M={self.m}); pick a partial-participation sampler from "
                f"{sorted(set(SAMPLERS) - {'all'})}")
        self.sampler = sampler
        self.seed = int(seed)
        w = (np.full((self.m,), 1.0 / self.m) if weights is None
             else np.asarray(weights, np.float64))
        self.weights = (w / w.sum()).astype(np.float32)
        # the weighted draw's probabilities, in float64 as numpy asks
        self._p = w / w.sum()
        self.availability = np.broadcast_to(
            np.asarray(availability, np.float32), (self.m,)).copy()

    @property
    def full_participation(self) -> bool:
        """True when every client runs every round: the full-participation
        round, not the cohort round, runs."""
        return self.sampler == "all"

    @classmethod
    def from_config(cls, fed, m: Optional[int] = None, weights=None
                    ) -> Optional["ClientPopulation"]:
        """Build from ``FedConfig`` cohort fields; None when the config asks
        for full participation (cohort_size ∈ {0, M}, sampler 'all').
        ``cohort_size < M`` alone implies partial participation, so the
        default sampler 'all' resolves to 'uniform' there."""
        m = int(m if m is not None else fed.n_clients)
        c = fed.cohort_size if fed.cohort_size > 0 else m
        sampler = fed.cohort_sampler
        if sampler == "all":
            if c == m:
                return None
            sampler = "uniform"
        return cls(m, cohort_size=c, sampler=sampler, seed=fed.seed,
                   weights=weights, availability=fed.availability)

    def cohort(self, t: int) -> np.ndarray:
        """(C,) int32 cohort for round ``t`` — pure in ``(seed, t)``."""
        rng = np.random.default_rng((self.seed, int(t), COHORT_STREAM))
        return SAMPLERS[self.sampler](self, rng, int(t))

    def cohort_weights(self, cohort: np.ndarray) -> np.ndarray:
        """(C,) float32 renormalized aggregation weights w̃ (module
        docstring)."""
        w = self.weights[np.asarray(cohort)]
        if self.sampler == "all":
            return w
        if self.sampler == "weighted":
            return np.full((self.cohort_size,), 1.0 / self.cohort_size,
                           np.float32)
        if self.sampler == "availability":
            # summed left to right in float32, as the reference's cohort
            # sizes are (numpy's own sum pairs terms from 8 on)
            return w / np.cumsum(w, dtype=np.float32)[-1]
        return w * np.float32(self.m / self.cohort_size)   # HT

    def cohort_and_weights(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        ids = self.cohort(t)
        return ids, self.cohort_weights(ids)

    def host_cohort(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """The cohort and its weights for round ``t`` (the port draws every
        cohort on the host: the reference's name for that draw)."""
        return self.cohort_and_weights(t)
