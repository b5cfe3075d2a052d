"""Failure-scenario layer (``repro.fed.scenarios`` counterpart): fault
injection as a pure function of ``(seed, round, client)``.

A :class:`Scenario` perturbs the per-round quantities the engines read:

* **effective steps** k′ ≤ K_i — mid-round dropout: the client aborts after
  k′ completed steps and its partial delta is still delivered.  The round
  runs the k′-step prefix (the per-row η of the calibrated update), FedNova
  aggregation normalizes by k′, and the aggregation and ν mass-mix weights
  are scaled by the delivered fraction k′/K_i
  (``stages.delivered_weights``).  k′ ≥ 1 always.
* **speed factor / latency extra** — straggler spikes and flaky-network
  bursts, read by the buffered engine's ``simulate_timeline``; the
  synchronous engine is insensitive to timing.
* **availability multiplier** — correlated diurnal phases, read by the
  ``availability`` cohort sampler and the buffered engine's dispatch
  profile.
* **payload corruption** — Byzantine clients: a fixed ``rate``-fraction of
  the fleet (drawn once per seed from its own stream) corrupts what
  crosses the wire, the delta rows and the ν transmit rows, with NaN/Inf
  injection, ×magnitude scaling, sign flips or resampled noise.  The
  defense is ``core/robust.py``.

Every draw is the reference's: ``jax.random`` threefry keyed
``fold_in(fold_in(fold_in(PRNGKey(seed ^ 0x5CE7A510), t), tag), client)``,
computed on the host in numpy by ``fed/keyed.py``, bit for bit.  The hooks
keep the reference's float32 operations in its order, so k′ rows, speed
factors, latencies and corrupt sets equal the reference's (availability
within ``AVAIL_MAX_ULP``: XLA's float32 ``cos`` is not correctly rounded).  Any subset of
clients evaluates to the values of the full row.

Timing hooks and the availability profile are host numpy functions; the
payload hooks run on the ``(B, P)`` device rows, with the corrupt set one
``(M,)`` bool tensor per device, made once.  ``garbage``'s Gaussian noise
rows are drawn on the host (``payload_noise``): the engines draw a
chunk's rows before the chunk and ship them with its inputs.
``scenario="baseline"`` maps to ``None``, and the engines then run their
unchanged rounds.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.fed import keyed

# base-key salt: scenario draws never collide with the cohort and batcher
# streams, which fold the raw config seed
_SALT = 0x5CE7A510
# the persistent corrupt-client set has its own stream, constant across
# rounds
_CORRUPT_SALT = 0x0BAD5EED
# payload kinds: the sub-stream tag of each corrupted quantity
_TAG_DELTA, _TAG_NU = 0, 1
# ``diurnal``'s availability against the reference's: at most this many
# float32 ulp apart
AVAIL_MAX_ULP = 1


def _client_uniform(key: np.ndarray, ids: np.ndarray, n: int = 1
                    ) -> np.ndarray:
    """(len(ids), n) float32 U[0, 1) draws keyed per client id — any subset
    of ids gives the same per-id values as the full row."""
    return keyed.uniform(keyed.fold_in(key, ids), (n,))


class Scenario:
    """A named device-fault model: per-round perturbation hooks.

    Hooks (any may be None = identity), host numpy functions:

    * ``k_eff(key_t, t, ids, k_ids) -> int32`` effective completed steps,
      ``1 ≤ k′ ≤ K`` elementwise.
    * ``speed(key_t, t, ids) -> float32`` multiplicative speed factors.
    * ``latency(key_t, t, ids) -> float32`` additive report delays (≥ 0).
    * ``avail(t) -> (M,) float32`` availability multipliers in [0, 1].
    * ``corrupt(hit, rows, n, noise) -> rows`` on float32 ``(B, P)`` device
      rows, ``hit`` the ``(B,)`` bool corrupt mask at the rows' ids, ``n``
      the true column count and ``noise`` the ``(B, P)`` noise rows of a
      scenario with ``needs_noise``.

    ``key_t`` is ONE folded key per (scenario, round) shared by all hooks,
    so correlated draws (a spike hitting both k′ and speed) see the same
    events.  In the buffered engine the "round" is the client's dispatch
    *wave* for the timing hooks and the server update for the payload.
    """

    def __init__(self, name: str, m: int, seed: int = 0, *,
                 k_eff: Optional[Callable] = None,
                 speed: Optional[Callable] = None,
                 latency: Optional[Callable] = None,
                 avail: Optional[Callable] = None,
                 corrupt: Optional[Callable] = None,
                 hit: Optional[np.ndarray] = None,
                 needs_noise: bool = False,
                 rejoin_delay: float = 0.0):
        self.name = str(name)
        self.m = int(m)
        self.seed = int(seed)
        self._k_eff = k_eff
        self._speed = speed
        self._latency = latency
        self._avail = avail
        self._corrupt = corrupt
        self.rejoin_delay = float(rejoin_delay)
        if self.rejoin_delay < 0:
            raise ValueError(f"rejoin_delay must be ≥ 0, "
                             f"got {self.rejoin_delay}")
        self._base = keyed.prng_key(self.seed ^ _SALT)
        # the (M,) corrupt set on the host, and once per device
        self.hit = hit
        self._hit_on: dict = {}
        self.needs_noise = bool(needs_noise)

    @property
    def perturbs_k(self) -> bool:
        return self._k_eff is not None

    @property
    def corrupts_payload(self) -> bool:
        return self._corrupt is not None

    @property
    def availability_fn(self) -> Optional[Callable]:
        """``t -> (M,)`` float32 availability multiplier, or None."""
        return self._avail

    def _key(self, t: int) -> np.ndarray:
        return keyed.fold_in(self._base, int(t))

    def _ids(self, ids) -> np.ndarray:
        return (np.arange(self.m, dtype=np.int64) if ids is None
                else np.asarray(ids, np.int64))

    # -- timing hooks (host) ---------------------------------------------------

    def k_eff(self, t: int, k, ids=None) -> np.ndarray:
        """Effective steps k′ for round/wave ``t`` (int32).  ``ids=None``:
        ``k`` is the full (M,) schedule row; else ``k`` holds the values at
        ``ids``."""
        k = np.asarray(k, np.int32)
        if self._k_eff is None:
            return k
        return self._k_eff(self._key(t), t, self._ids(ids), k)

    def speed_factor(self, t: int, ids=None) -> np.ndarray:
        ids_ = self._ids(ids)
        if self._speed is None:
            return np.ones(ids_.shape, np.float32)
        return self._speed(self._key(t), t, ids_)

    def latency_extra(self, t: int, ids=None) -> np.ndarray:
        ids_ = self._ids(ids)
        if self._latency is None:
            return np.zeros(ids_.shape, np.float32)
        return self._latency(self._key(t), t, ids_)

    def host_k_eff(self, t: int, k_row: np.ndarray) -> np.ndarray:
        return self.k_eff(t, k_row)

    def host_speed_factor(self, t: int) -> np.ndarray:
        return self.speed_factor(t).astype(np.float64)

    def host_latency_extra(self, t: int) -> np.ndarray:
        return self.latency_extra(t).astype(np.float64)

    def host_avail(self, t: int) -> np.ndarray:
        if self._avail is None:
            return np.ones(self.m)
        return np.asarray(self._avail(t), np.float64)

    def round_time(self, clock, t: int, k_row: np.ndarray) -> float:
        """Synchronous-round duration under this scenario: the (possibly
        slowed) straggler defines the round; aborted clients only run k′."""
        k = self.host_k_eff(t, k_row).astype(np.float64)
        f = self.host_speed_factor(t)
        lx = self.host_latency_extra(t)
        return float(np.max(k / (np.asarray(clock.speeds) * f)
                            + np.asarray(clock.latency) + lx))

    # -- payload hooks (device rows) -------------------------------------------

    def payload_noise(self, t: int, ids, p: int) -> Optional[np.ndarray]:
        """(2, B, P) float32 host noise rows of round/update ``t`` for the
        delta (0) and ν (1) payloads at ``ids``, or None when the scenario
        draws none.  Rows of honest clients stay zero (never read)."""
        if not self.needs_noise:
            return None
        ids_ = self._ids(ids)
        out = np.zeros((2, len(ids_), p), np.float32)
        bad = np.flatnonzero(self.hit[ids_])
        if bad.size:
            kt = self._key(t)
            for tag in (_TAG_DELTA, _TAG_NU):
                key = keyed.fold_in(keyed.fold_in(kt, tag), ids_[bad])
                out[tag, bad] = keyed.normal(key, (p,))
        return out

    def _hit_rows(self, ids, rows: torch.Tensor) -> torch.Tensor:
        dev = rows.device
        hit = self._hit_on.get(dev)
        if hit is None:
            hit = self._hit_on[dev] = torch.from_numpy(self.hit).to(dev)
        if ids is None:
            return hit[:rows.shape[0]]
        ids = torch.as_tensor(ids, device=dev)
        return hit.index_select(0, ids.long())

    def _corrupt_rows(self, t, rows: torch.Tensor, n: int, ids, tag: int,
                      noise) -> torch.Tensor:
        """Apply the payload-corruption hook to ``(B, P)`` wire rows.

        ``tag`` picks the payload's sub-stream (0 = delta, 1 = ν), so the
        two corruptions of one round are independent draws.  The hook sees
        float32 rows, and the result is cast back to the wire dtype, so
        NaN/Inf survive and scaling respects the transport precision.
        ``noise`` is the ``(B, P)`` device noise rows of this payload; a
        scenario that needs noise and is given none draws it on the host
        from ``t`` and ``ids`` (reading them from the device if they live
        there)."""
        if self._corrupt is None:
            return rows
        hit = self._hit_rows(ids, rows)
        if self.needs_noise and noise is None:
            t_host = int(t)
            ids_host = (None if ids is None
                        else torch.as_tensor(ids).cpu().numpy())
            noise = torch.from_numpy(self.payload_noise(
                t_host, ids_host, rows.shape[-1])[tag]).to(rows.device)
        out = self._corrupt(hit, rows.float(), n, noise)
        return out.to(rows.dtype)

    def corrupt_delta(self, t, rows: torch.Tensor, n: int, ids=None,
                      noise=None) -> torch.Tensor:
        """Corrupt the client→server delta rows for round/update ``t``."""
        return self._corrupt_rows(t, rows, n, ids, _TAG_DELTA, noise)

    def corrupt_nu(self, t, rows: torch.Tensor, n: int, ids=None,
                   noise=None) -> torch.Tensor:
        """Corrupt the client→server ν transmit rows for round ``t``."""
        return self._corrupt_rows(t, rows, n, ids, _TAG_NU, noise)


# ---------------------------------------------------------------------------
# named scenario builders
# ---------------------------------------------------------------------------

def dropout_scenario(m: int, *, rate: float = 0.1, seed: int = 0,
                     rejoin_delay: float = 0.0) -> Scenario:
    """Mid-round dropout: each (round, client) aborts w.p. ``rate`` after a
    uniform k′ ∈ {1, …, K_i − 1} completed steps (K_i = 1 clients cannot
    abort mid-round).  ``rejoin_delay`` keeps an aborted client offline
    for that many simulated seconds before its next async dispatch."""
    rate = float(rate)
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1], got {rate}")

    def k_eff(key, t, ids, k_ids):
        u = _client_uniform(keyed.fold_in(key, 1), ids, 2)
        drop = u[:, 0] < np.float32(rate)
        part = (1 + np.floor(u[:, 1] * (k_ids.astype(np.float32)
                                        - np.float32(1.0)))
                .astype(np.int32))
        return np.where(drop, np.minimum(part, k_ids), k_ids)

    return Scenario("dropout", m, seed, k_eff=k_eff,
                    rejoin_delay=rejoin_delay)


def spike_scenario(m: int, *, rate: float = 0.1, magnitude: float = 10.0,
                   frac: float = 0.25, seed: int = 0) -> Scenario:
    """Adversarial straggler spikes: w.p. ``rate`` a round is *spiked* — a
    random ``frac`` of clients runs ``magnitude``× slower.  In the
    synchronous round a spiked client completes ⌈K_i/magnitude⌉ steps
    (partial work); in the buffered engine its report slows by
    ``magnitude``×.  One shared event draw hits k′ and timing alike."""
    if magnitude < 1.0:
        raise ValueError(f"spike magnitude must be ≥ 1, got {magnitude}")

    def _hit(key, ids):
        spiked_round = (keyed.uniform(keyed.fold_in(key, 1))
                        < np.float32(rate))
        u = _client_uniform(keyed.fold_in(key, 2), ids)[:, 0]
        return spiked_round & (u < np.float32(frac))

    def k_eff(key, t, ids, k_ids):
        slow = np.ceil(k_ids.astype(np.float32)
                       / np.float32(magnitude)).astype(np.int32)
        return np.where(_hit(key, ids), np.maximum(slow, 1), k_ids)

    def speed(key, t, ids):
        return np.where(_hit(key, ids),
                        np.float32(1.0) / np.float32(magnitude),
                        np.float32(1.0)).astype(np.float32)

    return Scenario("spike", m, seed, k_eff=k_eff, speed=speed)


def flaky_scenario(m: int, *, rate: float = 0.1, magnitude: float = 5.0,
                   seed: int = 0) -> Scenario:
    """Flaky-network latency bursts: each (wave, client) report is delayed
    by an extra U[0, 2·magnitude] seconds w.p. ``rate``.  Pure timing
    noise: the synchronous engine is unchanged."""

    def latency(key, t, ids):
        u = _client_uniform(keyed.fold_in(key, 1), ids, 2)
        burst = u[:, 0] < np.float32(rate)
        return np.where(burst,
                        np.float32(2.0) * np.float32(magnitude) * u[:, 1],
                        np.float32(0.0)).astype(np.float32)

    return Scenario("flaky", m, seed, latency=latency)


def diurnal_scenario(m: int, *, period: float = 64.0, floor: float = 0.05,
                     seed: int = 0) -> Scenario:
    """Correlated diurnal availability: two hemispheres in antiphase —
    client i's up-probability is multiplied by
    ``floor + (1−floor)·½(1 + cos 2π(t/period + φ_i))`` with φ = 0 for the
    first half of the fleet and φ = ½ for the second.  Deterministic in
    (round, client)."""
    if period <= 0:
        raise ValueError(f"diurnal period must be > 0, got {period}")
    phase = (np.arange(m) >= m - m // 2).astype(np.float32) * np.float32(0.5)

    # the reference's expression as XLA compiles it on the CPU: the
    # division by the period a product with its float32 reciprocal, the
    # constant factors (1 − floor) · ½ folded into one, and the last
    # product and sum fused (one rounding, from float64 here); its cos is
    # within one ulp of the correctly rounded value, the float64 cos
    # rounded once
    inv_period = np.float32(1.0) / np.float32(period)
    half_span = np.float32(1.0 - floor) * np.float32(0.5)

    def avail(t):
        arg = np.float32(2.0 * np.pi) * (np.float32(t) * inv_period + phase)
        wave = 1.0 + np.cos(arg.astype(np.float64)).astype(np.float32)
        return (wave.astype(np.float64) * np.float64(half_span)
                + np.float64(np.float32(floor))).astype(np.float32)

    return Scenario("diurnal", m, seed, avail=avail)


def trace_scenario(speed_factors, *, latency_extras=None, avail=None,
                   name: str = "trace", seed: int = 0) -> Scenario:
    """Trace-driven device model: an explicit (T₀, M) table of per-round
    speed *factors* (round t uses row ``t mod T₀``), optionally with
    matching latency-extra and availability tables."""
    tbl = np.asarray(speed_factors, np.float32)
    if tbl.ndim != 2:
        raise ValueError(f"speed_factors must be (T, M), got shape "
                         f"{tbl.shape}")
    if not np.all(tbl > 0):
        raise ValueError("trace speed factors must be positive")
    t0, m = tbl.shape

    def _table(table):
        jt = np.asarray(table, np.float32)
        if jt.shape != (t0, m):
            raise ValueError(f"trace tables must share shape ({t0}, {m}), "
                             f"got {jt.shape}")
        return jt

    def speed(key, t, ids):
        return tbl[int(t) % t0][ids]

    latency = None
    if latency_extras is not None:
        lat = _table(latency_extras)
        if not np.all(np.asarray(latency_extras) >= 0):
            raise ValueError("trace latency extras must be ≥ 0")

        def latency(key, t, ids):                        # noqa: F811
            return lat[int(t) % t0][ids]

    avail_fn = None
    if avail is not None:
        av = _table(avail)

        def avail_fn(t):                                 # noqa: F811
            return av[int(t) % t0]

    return Scenario(name, m, seed, speed=speed, latency=latency,
                    avail=avail_fn)


# ---------------------------------------------------------------------------
# payload-corruption (Byzantine) scenario builders
# ---------------------------------------------------------------------------

def _corrupt_set(m: int, seed: int, rate: float) -> np.ndarray:
    """(M,) bool: the persistent corrupt-client set, drawn per client id
    from its own stream — the same for any subset of ids, any chunk split
    and any engine, and constant across rounds."""
    rate = float(rate)
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"corrupt rate must be in [0, 1], got {rate}")
    key = keyed.prng_key(seed ^ _SALT ^ _CORRUPT_SALT)
    u = _client_uniform(key, np.arange(m))[:, 0]
    return u < np.float32(rate)


def _cols(rows: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(rows.shape[-1], device=rows.device) < n


def _value_inject_scenario(name: str, value: float, m: int, *,
                           rate: float, seed: int) -> Scenario:
    def corrupt(hit, rows, n, noise):
        bad = hit[:, None] & _cols(rows, n)[None]
        return torch.where(bad, value, rows)

    return Scenario(name, m, seed, corrupt=corrupt,
                    hit=_corrupt_set(m, seed, rate))


def nan_inject_scenario(m: int, *, rate: float = 0.1,
                        seed: int = 0) -> Scenario:
    """Corrupt clients report all-NaN payloads."""
    return _value_inject_scenario("nan_inject", float("nan"), m,
                                  rate=rate, seed=seed)


def inf_inject_scenario(m: int, *, rate: float = 0.1,
                        seed: int = 0) -> Scenario:
    """Corrupt clients report all-Inf payloads."""
    return _value_inject_scenario("inf_inject", float("inf"), m,
                                  rate=rate, seed=seed)


def scale_attack_scenario(m: int, *, rate: float = 0.1,
                          magnitude: float = 10.0,
                          seed: int = 0) -> Scenario:
    """Corrupt clients scale their payload ×``magnitude`` (model
    boosting: drags the weighted mean, and through ν every client's
    calibration, toward the attacker)."""
    if magnitude <= 0:
        raise ValueError(f"scale magnitude must be > 0, got {magnitude}")

    def corrupt(hit, rows, n, noise):
        f = torch.where(hit, float(np.float32(magnitude)), 1.0)
        return rows * f[:, None]

    return Scenario("scale_attack", m, seed, corrupt=corrupt,
                    hit=_corrupt_set(m, seed, rate))


def sign_flip_scenario(m: int, *, rate: float = 0.1,
                       seed: int = 0) -> Scenario:
    """Corrupt clients negate their payload (an honest norm, the wrong
    direction: survives naive clipping)."""
    def corrupt(hit, rows, n, noise):
        f = torch.where(hit, -1.0, 1.0)
        return rows * f[:, None]

    return Scenario("sign_flip", m, seed, corrupt=corrupt,
                    hit=_corrupt_set(m, seed, rate))


def garbage_scenario(m: int, *, rate: float = 0.1, magnitude: float = 10.0,
                     seed: int = 0) -> Scenario:
    """Corrupt clients replace their payload with fresh Gaussian noise
    rescaled to ``magnitude``× the honest row's norm — per (round, client,
    payload-kind) draws keyed like every other scenario."""
    if magnitude <= 0:
        raise ValueError(f"garbage magnitude must be > 0, got {magnitude}")
    mag = float(np.float32(magnitude))

    def corrupt(hit, rows, n, noise):
        noise = torch.where(_cols(rows, n)[None], noise, 0.0)
        rn = torch.sqrt(torch.sum(rows * rows, dim=-1))
        nn = torch.sqrt(torch.sum(noise * noise, dim=-1))
        g = noise * (mag * rn / torch.clamp(nn, min=1e-12))[:, None]
        return torch.where(hit[:, None], g, rows)

    return Scenario("garbage", m, seed, corrupt=corrupt,
                    hit=_corrupt_set(m, seed, rate), needs_noise=True)


def _trace_from_config(fed, m: int) -> Scenario:
    raise ValueError(
        "scenario='trace' needs explicit per-round device data that a "
        "FedConfig cannot carry; build it with "
        "repro_torch.fed.scenarios.trace_scenario(speed_factors, ...) and "
        "pass scenario=... to the engine (or use make_clock(dist='trace', "
        "speeds=...) for a static empirical speed profile)")


# registry — name -> builder(fed_config, m) -> Scenario | None
SCENARIOS: dict[str, Callable] = {
    "baseline": lambda fed, m: None,
    "dropout": lambda fed, m: dropout_scenario(
        m, rate=fed.dropout_rate, seed=fed.seed,
        rejoin_delay=fed.rejoin_delay),
    "diurnal": lambda fed, m: diurnal_scenario(
        m, period=fed.scenario_period, seed=fed.seed),
    "spike": lambda fed, m: spike_scenario(
        m, rate=fed.scenario_rate, magnitude=fed.scenario_magnitude,
        seed=fed.seed),
    "flaky": lambda fed, m: flaky_scenario(
        m, rate=fed.scenario_rate, magnitude=fed.scenario_magnitude,
        seed=fed.seed),
    "trace": _trace_from_config,
    # payload corruption: fed.scenario_rate is the corrupt-client
    # fraction, fed.scenario_magnitude the attack strength
    "nan_inject": lambda fed, m: nan_inject_scenario(
        m, rate=fed.scenario_rate, seed=fed.seed),
    "inf_inject": lambda fed, m: inf_inject_scenario(
        m, rate=fed.scenario_rate, seed=fed.seed),
    "scale_attack": lambda fed, m: scale_attack_scenario(
        m, rate=fed.scenario_rate, magnitude=fed.scenario_magnitude,
        seed=fed.seed),
    "sign_flip": lambda fed, m: sign_flip_scenario(
        m, rate=fed.scenario_rate, seed=fed.seed),
    "garbage": lambda fed, m: garbage_scenario(
        m, rate=fed.scenario_rate, magnitude=fed.scenario_magnitude,
        seed=fed.seed),
}


def make_scenario(fed, m: Optional[int] = None) -> Optional[Scenario]:
    """Resolve ``fed.scenario`` to a :class:`Scenario` — None for
    ``"baseline"``, so the engines run their unperturbed rounds."""
    if fed.scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {fed.scenario!r}; valid "
                         f"options: {sorted(SCENARIOS)}")
    return SCENARIOS[fed.scenario](fed, int(m if m is not None
                                            else fed.n_clients))
