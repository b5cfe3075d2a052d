"""Client population: partial participation and cohort sampling
(``repro.fed.population`` counterpart).

The server keeps per-client metadata (data mass ω_i, availability) for the
whole population of M clients while each round runs only a sampled
**cohort** of C ≤ M clients.  Samplers are pluggable through ``SAMPLERS``
(name → draw function).

The draws run on the host and are the reference's own: round ``t``'s key
is ``fold_in(PRNGKey(seed), t)``, computed in numpy by ``fed/keyed.py``.
The uniform draw is the reference's O(C) keyed permutation (Feistel +
cycle-walking) with its round keys ``random_bits(key_t, (4,))``, in
numpy ``uint32`` (whose products wrap), bit for bit.  The weighted draw is
``jax.random.choice``'s with replacement: a float32 cumulative sum of the
weights in XLA's order (``keyed.cumsum``), ``r = cumsum[-1]·(1 − u)`` and
a left ``searchsorted``, bit for bit.  The availability draw splits
``key_t`` (``fold_in(key_t, 0)`` and ``fold_in(key_t, 1)``), marks client
i up where its uniform is below its availability, and ranks Gumbel scores
largest first, ties to the lower index, as ``lax.top_k`` does.  numpy's float32 ``log`` is within
``GUMBEL_MAX_ULP`` of XLA's, not always equal, so an availability cohort
is the reference's unless two of its candidates' scores lie that close
(``tests/test_torch_population.py`` holds the rule on a grid).  The
weighted and availability draws are O(M) host work per round.

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

The buffered-async engine (fed/async_engine.py) reads the population
through its dispatch hooks, the reference's own, numpy for numpy: the
timeline (fed/clock.py) draws ``initial_dispatch`` and every
``pick_dispatch`` from one ``default_rng((seed, 0x5eed))`` stream, so the
same seed gives the reference's picks bit for bit; ``report_weights`` are
the per-report base weights and ``step_rate`` scales the clock's speeds.
A time-varying availability hook (``availability_fn``, set by a failure
scenario such as ``diurnal``) multiplies the static profile, in the cohort
draw and in the dispatch profile alike.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.fed import keyed

# a Gumbel score against the reference's: within this many float32 ulp of
# |score| + 1 (numpy's float32 log is not XLA's)
GUMBEL_MAX_ULP = 4


# ---------------------------------------------------------------------------
# sampler registry — fn(pop, key, t) -> (C,) int32 client ids, ``key`` the
# round's keyed-draw key (fed/keyed.py)
# ---------------------------------------------------------------------------

def _sample_all(pop: "ClientPopulation", key: np.ndarray,
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


def _sample_uniform(pop: "ClientPopulation", key: np.ndarray,
                    t: int) -> np.ndarray:
    """Uniform WITHOUT replacement in O(C): a keyed pseudorandom
    permutation of [0, M) evaluated at points 0…C-1 — distinct by
    bijectivity, and never touching M elements."""
    return _permutation_points(keyed.random_bits(key, (4,)), pop.m,
                               np.arange(pop.cohort_size, dtype=np.uint32))


def _sample_weighted(pop: "ClientPopulation", key: np.ndarray,
                     t: int) -> np.ndarray:
    """Weight-proportional WITH replacement (p = ω): aggregate with uniform
    1/C weights.  An id can come out more than once."""
    r = pop._cumw[-1] * (np.float32(1.0)
                         - keyed.uniform(key, (pop.cohort_size,)))
    ids = np.searchsorted(pop._cumw, r, side="left")
    return np.minimum(ids, pop.m - 1).astype(np.int32)


def _top_k(score: np.ndarray, k: int) -> np.ndarray:
    """``lax.top_k``'s indices in O(M): the k largest scores, largest
    first, ties to the lower index."""
    kth = np.partition(score, score.size - k)[score.size - k]
    above = np.flatnonzero(score > kth)
    tied = np.flatnonzero(score == kth)[:k - above.size]
    top = np.concatenate([above, tied])
    return top[np.lexsort((top, -score[top]))]


def _sample_availability(pop: "ClientPopulation", key: np.ndarray,
                         t: int) -> np.ndarray:
    """Client i is up this round w.p. availability_i; the cohort is a
    uniform draw among available clients, by Gumbel scores, largest first.
    A scenario's availability hook multiplies the static profile by its
    row for round t.  Unavailable clients fill the cohort only when fewer
    than C are up: their scores are pushed to −1e9, below every available
    client's, where float32 rounding ties them, so the fill is the lowest
    unavailable ids."""
    k_up, k_pick = keyed.split(key)
    p = pop.availability
    if pop.availability_fn is not None:
        p = p * np.asarray(pop.availability_fn(t), np.float32)
    up = keyed.uniform(k_up, (pop.m,)) < p
    score = keyed.gumbel(k_pick, (pop.m,)) + np.where(
        up, np.float32(0.0), np.float32(-1e9))
    return _top_k(score, pop.cohort_size).astype(np.int32)


def _sample_round_robin(pop: "ClientPopulation", key: np.ndarray,
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
    reference), ``step_rate`` the relative local-step speed profile (the
    async clock's speeds are multiplied by it), ``availability`` the
    per-client up-probability the ``availability`` sampler uses.  Scalars
    broadcast to (M,).  Draws and weights are numpy arrays on the host."""

    def __init__(self, m: int, *, cohort_size: Optional[int] = None,
                 sampler: str = "uniform", seed: int = 0, weights=None,
                 step_rate=None, availability=1.0):
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
        # the weighted draw's float32 cumulative sum, in jnp.cumsum's order
        self._cumw = keyed.cumsum(self.weights)
        self._key = keyed.prng_key(self.seed)
        self.step_rate = np.broadcast_to(
            np.asarray(1.0 if step_rate is None else step_rate, np.float64),
            (self.m,)).copy()
        self.availability = np.broadcast_to(
            np.asarray(availability, np.float32), (self.m,)).copy()
        self._rr_next = 0             # round-robin dispatch pointer (async)
        self._cdf = None              # lazily-built dispatch-profile CDF
        # a time-varying availability multiplier ``t -> (M,)`` (host numpy)
        # that a failure scenario attaches; None = the static profile
        self.availability_fn = None
        self._cdf_cache: dict[int, np.ndarray] = {}

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
        """(C,) int32 cohort for round ``t`` — pure in ``(seed, t)``: the
        reference's draw from ``fold_in(PRNGKey(seed), t)``."""
        key = keyed.fold_in(self._key, int(t))
        return SAMPLERS[self.sampler](self, key, int(t))

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
        """The cohort and its weights for round ``t``: the reference's
        keyed draw, evaluated on the host as every port engine draws it
        (the cohort of ``repro``'s ``host_cohort(t)`` for the same seed)."""
        return self.cohort_and_weights(t)

    # -- async-engine hooks (host-side event loop, fed/clock.py) -------------

    def report_weights(self) -> np.ndarray:
        """(M,) float32 base per-REPORT aggregation weights for the
        buffered-async engine (the staleness discount multiplies on top):
        ``cohort_weights``'s renormalization with the buffer in the
        cohort's place (availability has no per-buffer normalizer on the
        host and shares the Horvitz–Thompson rule)."""
        w = np.asarray(self.weights, np.float64)
        if self.sampler == "all":
            return w.astype(np.float32)
        if self.sampler == "weighted":
            return np.full((self.m,), 1.0 / self.cohort_size, np.float32)
        return (w * (self.m / self.cohort_size)).astype(np.float32)

    def initial_dispatch(self, rng: np.random.Generator) -> np.ndarray:
        """The C distinct clients in flight at t = 0."""
        if self.sampler == "all":
            return np.arange(self.m)
        if self.sampler == "round_robin":
            self._rr_next = self.cohort_size % self.m
            return np.arange(self.cohort_size) % self.m
        p = self._dispatch_profile()
        if np.count_nonzero(p) < self.cohort_size:
            # fewer ever-available clients than slots: pad the profile so a
            # distinct draw exists (the cohort sampler's fill rule)
            p = (p + 1.0 / self.m) / (p.sum() + 1.0)
        return rng.choice(self.m, self.cohort_size, replace=False, p=p)

    def pick_dispatch(self, rng: np.random.Generator, busy: np.ndarray,
                      freed: int, phase: int = 0) -> int:
        """The next client to dispatch among idle (``~busy``) clients — the
        buffered-async analogue of the cohort draw (one slot frees per
        report, so concurrency stays capped at C).

        O(1) expected per event: stochastic samplers draw from the profile
        CDF and reject busy clients (busy mass ≈ C/M), falling back to an
        O(M) scan only after 64 rejections; ``all`` re-dispatches the
        reporter with no draw and ``round_robin`` walks its cyclic pointer
        past busy clients.  ``phase`` (the server update index) matters only
        with an ``availability_fn``: the dispatch profile then follows the
        time-varying availability (diurnal clients stop being dispatched
        at night)."""
        if self.sampler == "all":
            return int(freed)                  # the only idle client
        if self.sampler == "round_robin":
            for _ in range(self.m):
                i = self._rr_next
                self._rr_next = (i + 1) % self.m
                if not busy[i]:
                    return i
            raise RuntimeError("no idle client (caller must free one)")
        cdf = self._profile_cdf(phase)
        for _ in range(64):
            i = min(int(np.searchsorted(cdf, rng.random(), side="right")),
                    self.m - 1)
            if not busy[i]:
                return i
        ids = np.flatnonzero(~busy)
        p = self._dispatch_profile(phase)[ids]
        if p.sum() <= 0:                 # every idle client unavailable:
            p = np.ones(len(ids))        # fall back to a uniform pick
        return int(rng.choice(ids, p=p / p.sum()))

    def _avail_profile(self, phase: int) -> np.ndarray:
        p = np.asarray(self.availability, np.float64)
        if self.availability_fn is not None:
            p = p * np.asarray(self.availability_fn(phase), np.float64)
        return p

    def _dispatch_profile(self, phase: int = 0) -> np.ndarray:
        if self.sampler == "weighted":
            p = np.asarray(self.weights, np.float64)
        elif self.sampler == "availability":
            p = self._avail_profile(phase)
        else:                                   # all / uniform / round_robin
            p = np.ones(self.m)
        s = p.sum()
        return p / s if s > 0 else np.full(self.m, 1.0 / self.m)

    def _profile_cdf(self, phase: int = 0) -> np.ndarray:
        if self.availability_fn is None or self.sampler != "availability":
            if self._cdf is None:
                self._cdf = np.cumsum(self._dispatch_profile())
                self._cdf[-1] = 1.0
            return self._cdf
        # one CDF per phase, LRU-capped as in the reference
        cdf = self._cdf_cache.pop(phase, None)
        if cdf is None:
            cdf = np.cumsum(self._dispatch_profile(phase))
            cdf[-1] = 1.0
        self._cdf_cache[phase] = cdf
        while len(self._cdf_cache) > 32:
            self._cdf_cache.pop(next(iter(self._cdf_cache)))
        return cdf
