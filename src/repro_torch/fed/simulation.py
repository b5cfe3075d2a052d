"""Single-device federated simulator (``repro.fed.simulation`` counterpart).

Drives the flat synchronous round (core/flat.py) over T rounds: samples the
K_i schedule, assembles per-round microbatches, and records loss and eval
metrics (per client too, through ``eval_per_client``, which
``History.fairness`` reads).  ``run`` executes blocks of ``chunk_rounds``
rounds (core/engine.py) and waits for the device only at chunk boundaries;
the eval cadence sets the default chunk size, and ``chunk_rounds=1`` is the
per-round path.  A chunk computes exactly what the same rounds computed one
by one.

Partial participation (fed/population.py): with ``cohort_size < M`` each
round runs a cohort of C clients drawn on the host from ``(seed, t)``
(``make_flat_cohort_round``), its batches gathered for the cohort only,
while the ν⁽ⁱ⁾ store stays population-sized on the device; the run owns its
state, so rounds update that store in place.  A chunk of cohort rounds
(``engine.make_population_chunk``) computes exactly what its rounds
computed one by one.

Failure scenarios (fed/scenarios.py) perturb each round on the host with
the reference's keyed draws: a k′ row replaces the K row (the round runs
the k′-step prefix), cohort weights are scaled by the delivered fraction
k′/K, ``History.dropped`` records the abort fraction, and a payload attack
corrupts the wire inside the round, where the robust-aggregation stage
(core/robust.py, ``FedConfig.defense`` / ``quarantine_window``) screens
it; ``History.quarantined`` records the quarantined reporters.  An
attack's noise rows (``garbage``) are drawn on the host before a chunk and
go to the device with its inputs.

With a device batcher (``data.DeviceBatcher``: a batcher with ``sample``)
the chunks run in device mode (core/engine.py): a chunk draws its rounds'
batches on the device from the reference's keyed indices, and a cohort
chunk draws its cohorts and a scenario's k′ rows on the host in the chunk
(the reference's in-scan ``scenario_fn``), so per-round and chunked runs
stay bit-identical.  ``run(publish_fn=, publish_every=)`` publishes a
serving snapshot (``publish_snapshot``) every ``publish_every`` rounds,
chunks never crossing a publish boundary; a run's ``state`` saves with
``checkpoint.save(path, sim.state)`` and restores with ``sim.state =
checkpoint.load(path, sim.state)``, and a restored simulation's next
``run`` continues as the saved one's would have.

Both of the reference's parameter layouts run (``FedConfig.param_layout``):
"tree", its default, keeps the model a tree of tensors and runs the tree
rounds (``rounds.make_round``, ``stages.make_cohort_round``: plain torch
per leaf, the wire stages through the flat view table), "flat" the
single-buffer rounds of core/flat.py (one calibrated-update launch a local
step; with ``FedConfig.master_dtype`` the float32 buffer under bfloat16
leaves).  Either runs full participation and cohort rounds, with or without
wire compression (core/compress.py), a scenario or a defense; a tree run
builds the ``FlatSpec`` only when its wire stages need one (``flat_spec``
builds it on first use otherwise), and its compression and health state
are flat rows, as in the reference.  As in the reference, this engine runs
its synchronous round whatever ``buffer_size`` says: the buffered engine is
``fed.async_engine.BufferedAsyncSimulation``.  Every run records the wire
bytes per round (``History.bytes_up`` / ``bytes_down``) at the number of
clients that report, at the fp32 cost when compression is off.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import serialize
from repro_torch.configs.base import FedConfig
from repro_torch.core import compress, engine, flat, robust, rounds, stages
from repro_torch.core.fedopt import get_algorithm
from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.data.partition import gaussian_k_schedule
from repro_torch.device import resolve_device
from repro_torch.fed.population import ClientPopulation
from repro_torch.fed.scenarios import Scenario, make_scenario

PyTree = Any


def _check_finite_metric(value: float, t: int) -> None:
    """Fail loudly at the eval boundary: a non-finite metric means the run
    diverged or was poisoned."""
    if not np.isfinite(value):
        raise FloatingPointError(
            f"evaluation metric is non-finite ({value}) after round {t}: "
            f"the run has diverged or been poisoned; configure a defense "
            f"(FedConfig.defense / quarantine_window, core/robust.py)")


@dataclasses.dataclass
class History:
    loss: list[float] = dataclasses.field(default_factory=list)
    metric: list[float] = dataclasses.field(default_factory=list)
    kbar: list[float] = dataclasses.field(default_factory=list)
    wall: list[float] = dataclasses.field(default_factory=list)
    # ``eval_per_client``'s values at each eval boundary, one per client
    per_client: list[list[float]] = dataclasses.field(default_factory=list)
    # wire bytes per round under the configured compressors
    # (compress.wire_cost × participants), recorded on every run, at the
    # fp32 cost when compression is off, so runs compare directly
    bytes_up: list[float] = dataclasses.field(default_factory=list)
    bytes_down: list[float] = dataclasses.field(default_factory=list)
    # cohort rounds and buffered updates: the weight mass Σ w̃ per round
    mass: list[float] = dataclasses.field(default_factory=list)
    # buffered-async engine (fed/async_engine.py): simulated arrival time of
    # each server update and the mean staleness of its buffer
    sim_time: list[float] = dataclasses.field(default_factory=list)
    staleness: list[float] = dataclasses.field(default_factory=list)
    # failure scenarios (fed/scenarios.py): per-round/update fraction of
    # mid-round dropouts (k′ < K_i) — population-level for the sync engine,
    # buffer-level for the async engine; empty without a scenario
    dropped: list[float] = dataclasses.field(default_factory=list)
    # robust aggregation (core/robust.py): participants excluded by an
    # active quarantine each round/update; empty without a defense
    quarantined: list[float] = dataclasses.field(default_factory=list)

    def fairness(self) -> Optional[dict]:
        """FL fairness of the final round: worst-client metric and the
        across-client std (Li et al. q-FFL reporting convention)."""
        if not self.per_client:
            return None
        last = self.per_client[-1]
        return {"worst": min(last), "best": max(last),
                "std": float(np.std(last))}

    def rounds_to_target(self, target: float, higher_is_better=True
                         ) -> Optional[int]:
        for t, v in enumerate(self.metric):
            if (v >= target) if higher_is_better else (v <= target):
                return t + 1
        return None

    def bytes_to_target(self, target: float, higher_is_better=True
                        ) -> Optional[float]:
        """Cumulative uplink bytes spent when the eval metric first reaches
        ``target`` — None if it never does."""
        r = self.rounds_to_target(target, higher_is_better)
        if r is None or not self.bytes_up or not self.metric:
            return None
        per_eval = max(1, len(self.bytes_up) // len(self.metric))
        return float(sum(self.bytes_up[:r * per_eval]))


class FederatedSimulation:
    """``run(T)`` executes T rounds of ``fed.algorithm`` on one device
    (``device=None``: the card; pass ``"cpu"`` to run on the CPU).

    ``params`` is the model tree (dicts and lists of tensors: a paper
    model's dict or an LM's ``{"segments": [...], …}``); ``batcher`` a
    ``FederatedBatcher``, ``LMFederatedBatcher``, ``DeviceBatcher`` or
    ``DeviceLMBatcher`` on the same device (cohort rounds need cohort
    methods: the host ``FederatedBatcher``'s or a device batcher's).
    ``population`` overrides the config's cohort fields (its M must be
    ``fed.n_clients``), ``scenario`` overrides ``fed.scenario`` (a
    ``trace_scenario``, which a config cannot carry)."""

    def __init__(self, loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                 params: PyTree, fed: FedConfig, batcher,
                 eval_fn: Optional[Callable[[PyTree], float]] = None,
                 eval_per_client: Optional[Callable[[PyTree],
                                                    list]] = None,
                 k_schedule: Optional[np.ndarray] = None,
                 lam_schedule: Optional[Callable[[int], float]] = None,
                 population: Optional[ClientPopulation] = None,
                 scenario: Optional[Scenario] = None,
                 t_max: int = 10_000,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if batcher.device != self.device:
            raise ValueError(f"batcher is on {batcher.device}, the "
                             f"simulation on {self.device}")
        self.fed = fed
        self.algo = get_algorithm(fed.algorithm, fed)
        self.batcher = batcher
        self.eval_fn = eval_fn
        self.eval_per_client = eval_per_client
        self.lam_schedule = lam_schedule
        if k_schedule is None:
            k_schedule = gaussian_k_schedule(
                fed.n_clients, fed.k_mean, fed.k_var, t_max,
                mode=fed.k_mode, seed=fed.seed)
        self.k_schedule = k_schedule
        self.k_max = int(k_schedule.max())
        self.weights = (batcher.weights if fed.weights == "data"
                        else torch.full((fed.n_clients,),
                                        1.0 / fed.n_clients,
                                        dtype=torch.float32,
                                        device=self.device))
        self.layout = fed.param_layout
        # failure scenario: None for "baseline", and every run path then
        # takes its unperturbed round.  Resolved before the spec: a payload
        # attack works on wire rows, so the tree layout needs the view
        # table for it, as for compression
        self.scenario = (scenario if scenario is not None
                         else make_scenario(fed))
        if self.scenario is not None and self.scenario.m != fed.n_clients:
            raise ValueError(
                f"scenario for {self.scenario.m} clients does not "
                f"match fed.n_clients={fed.n_clients}")
        self._attack = (self.scenario
                        if self.scenario is not None
                        and self.scenario.corrupts_payload else None)
        # robust aggregation: None when defense="none" and quarantine is
        # off, and the rounds are then the unchanged ones
        self.robust = robust.RobustConfig.from_fed(fed)
        # wire compression: None when the config asks for none, and the
        # round is then the unchanged one
        self.compression = compress.CompressionConfig.from_fed(fed)
        if self.layout == "flat":
            self._spec = flat.make_flat_spec(
                params, master_dtype=fed.master_dtype or None)
        elif (self.compression is not None or self.robust is not None
                or self._attack is not None):
            # the tree round works the wire rows through the view table:
            # it needs the spec (and flat error-feedback and health state)
            # while the params stay a tree
            self._spec = flat.make_flat_spec(params)
        else:
            self._spec = None
        n_true = (self._spec.n if self._spec is not None
                  else sum(lv.numel() for lv in tree_leaves(params)))
        self._wire = compress.wire_cost(n_true, self.algo.uses_nu,
                                        self.compression)
        # a private copy on the device: the run replaces and updates its
        # state, never the caller's tensors
        params = (flat.ravel(self._spec, params).to(self.device)
                  if self.layout == "flat"
                  else tree_map(lambda a: a.detach().to(self.device,
                                                        copy=True), params))
        self.state = rounds.init_state(
            params, fed.n_clients, self.algo, compression=self.compression,
            spec=self._spec, robust=self.robust)
        self._loss_fn = loss_fn
        self._round: Optional[Callable] = None
        self._chunks: dict[int, Callable] = {}
        # a device batcher draws the batches on the device, in the chunk
        self._device_sampler = callable(getattr(batcher, "sample", None))
        # partial participation: sampler "all" (or no population) stays on
        # the full-participation round
        self.population = (population if population is not None
                           else ClientPopulation.from_config(
                               fed, m=fed.n_clients,
                               weights=self.weights.cpu().numpy()))
        self._partial = (self.population is not None
                         and not self.population.full_participation)
        if (self.population is not None
                and self.population.m != fed.n_clients):
            raise ValueError(
                f"population of {self.population.m} clients does not match "
                f"fed.n_clients={fed.n_clients}")
        if self._partial and not (
                hasattr(batcher, "cohort_batches")
                or hasattr(batcher, "sample_cohort")):
            raise ValueError("cohort rounds need a batcher with cohort "
                             "methods (FederatedBatcher or DeviceBatcher)")
        if (self.scenario is not None
                and self.scenario.availability_fn is not None
                and self.population is not None):
            self.population.availability_fn = self.scenario.availability_fn

    def _build_round(self) -> Callable:
        """The one synchronous-round builder every path shares: the tree
        round or its single-buffer twin, both ``round_fn(state, batches,
        k_steps, weights, lam, *, noise=None)``."""
        kw = dict(lr=self.fed.lr, k_max=self.k_max,
                  compression=self.compression, robust=self.robust,
                  attack=self._attack)
        if self.layout == "flat":
            return flat.make_flat_round(self._spec, self._loss_fn, self.algo,
                                        **kw)
        return rounds.make_round(self._loss_fn, self.algo, spec=self._spec,
                                 **kw)

    def _round_fn(self) -> Callable:
        if self._round is None:
            self._round = self._build_round()
        return self._round

    def _chunk_fn(self, r: int) -> Callable:
        if r not in self._chunks:
            # the chunk takes the state over (freeing the pre-chunk state
            # after round 1), and hands back the last finished round's
            # state if a round raises
            sample = ((lambda ts: self.batcher.sample_chunk(
                ts, None, self.k_max)) if self._device_sampler else None)
            self._chunks[r] = engine.make_round_chunk(
                self._round_fn(), r, donate=True, sample_fn=sample)
        return self._chunks[r]

    def _pop_round_fn(self) -> Callable:
        """The one cohort-round builder both population paths share."""
        if self._round is None:
            kw = dict(lr=self.fed.lr, k_max=self.k_max,
                      nu_decay=self.fed.cohort_nu_decay,
                      compression=self.compression, robust=self.robust,
                      attack=self._attack)
            self._round = (
                flat.make_flat_cohort_round(self._spec, self._loss_fn,
                                            self.algo, **kw)
                if self.layout == "flat"
                else stages.make_cohort_round(self._loss_fn, self.algo,
                                              spec=self._spec, **kw))
        return self._round

    def _pop_chunk_fn(self, r: int) -> Callable:
        if r not in self._chunks:
            kw = {}
            if self._device_sampler:
                scn, k_max = self.scenario, self.k_max
                kw = dict(
                    cohort_fn=self.population.host_cohort,
                    sample_fn=lambda ts, ids: self.batcher.sample_chunk(
                        ts, ids, k_max),
                    scenario_fn=(
                        (lambda t, k_c, ids: scn.k_eff(t, k_c, ids=ids))
                        if scn is not None and scn.perturbs_k else None))
            self._chunks[r] = engine.make_population_chunk(
                self._pop_round_fn(), r, donate=True, **kw)
        return self._chunks[r]

    def _lam(self, t: int) -> float:
        return (float(self.lam_schedule(t)) if self.lam_schedule
                else self.algo.lam)

    def _sched_row(self, t: int) -> np.ndarray:
        return np.asarray(self.k_schedule[t % len(self.k_schedule)])

    def _k_host(self, t: int) -> np.ndarray:
        """Round t's effective K row: the schedule row, perturbed to k′ by
        the scenario (the reference's keyed draws)."""
        row = self._sched_row(t)
        if self.scenario is None or not self.scenario.perturbs_k:
            return row
        return self.scenario.host_k_eff(t, row)

    def _k_row(self, t: int) -> torch.Tensor:
        return torch.as_tensor(self._k_host(t), dtype=torch.int32,
                               device=self.device)

    def _record_dropped(self, hist: History, t0: int, r: int) -> None:
        """Population-level abort fraction per round (pure in (seed, t))."""
        if self.scenario is None:
            return
        if not self.scenario.perturbs_k:
            hist.dropped.extend([0.0] * r)
            return
        hist.dropped.extend(
            float(np.mean(self._k_host(t0 + j) < self._sched_row(t0 + j)))
            for j in range(r))

    def _noise(self, r: int, cohorts: Optional[np.ndarray] = None
               ) -> Optional[torch.Tensor]:
        """(r, 2, B, P) noise rows of the next r rounds' payload attack on
        the device (one transfer), or None when the attack draws none.
        The draws are keyed by the state's round counter, as in the
        reference's round (read from the device: a restored state keys
        them as the saved one would have)."""
        if self._attack is None or not self._attack.needs_noise:
            return None
        done = int(self.state["round"])
        rows = [self._attack.payload_noise(
            done + j,
            None if cohorts is None else cohorts[j], self.flat_spec.p)
            for j in range(r)]
        return self._on_device(np.stack(rows), torch.float32)

    def _record_metrics(self, hist: History, metrics: dict, r: int) -> None:
        for key in ("loss", "kbar", "mass", "quarantined"):
            if key in metrics:
                getattr(hist, key).extend(
                    metrics[key].double().reshape(-1).tolist())

    def _sync(self) -> None:
        """End of a timed region: wait for the device's work (the
        counterpart of the reference's ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record_bytes(self, hist: History, r: int, participants: int
                      ) -> None:
        """Wire traffic of r rounds of ``participants`` reports each."""
        hist.bytes_up.extend(
            [participants * self._wire["uplink_per_client"]] * r)
        hist.bytes_down.extend(
            [participants * self._wire["downlink_per_client"]] * r)

    def _run_round(self, t: int, hist: History) -> None:
        """The chunk_rounds=1 path: one round, one host sync."""
        lam = self._lam(t)
        round_fn = self._round_fn()
        k_t = self._k_row(t)
        batches = self.batcher.round_batches(t, self.k_max)
        noise = self._noise(1)
        kw = {} if noise is None else {"noise": noise[0]}
        t0 = time.perf_counter()
        self.state, metrics = round_fn(self.state, batches, k_t,
                                       self.weights, lam, **kw)
        self._sync()
        hist.wall.append(time.perf_counter() - t0)
        self._record_metrics(hist, metrics, 1)
        self._record_dropped(hist, t, 1)
        self._record_bytes(hist, 1, self.fed.n_clients)

    def _run_chunk(self, t0: int, r: int, hist: History) -> None:
        chunk_fn = self._chunk_fn(r)
        batches = (list(range(t0, t0 + r)) if self._device_sampler
                   else self.batcher.chunk_batches(t0, r, self.k_max))
        ks = torch.stack([self._k_row(t0 + j) for j in range(r)])
        weights = self.weights.expand(r, -1)
        lams = [self._lam(t0 + j) for j in range(r)]
        noise = self._noise(r)
        tic = time.perf_counter()
        self.state, metrics = chunk_fn(self.state, batches, ks, weights,
                                       lams, noise=noise)
        self._sync()
        dt = time.perf_counter() - tic
        self._record_metrics(hist, metrics, r)
        hist.wall.extend([dt / r] * r)
        self._record_dropped(hist, t0, r)
        self._record_bytes(hist, r, self.fed.n_clients)

    # -- partial participation ------------------------------------------------

    def _on_device(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dtype=dtype, device=self.device)

    def _cohort_k(self, t: int, ids: np.ndarray, cw: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
        """The cohort's K (k′ under a scenario) and weights, scaled by the
        delivered fraction k′/K (``stages.delivered_weights``)."""
        k_c = self._sched_row(t)[ids]
        if self.scenario is None or not self.scenario.perturbs_k:
            return k_c, cw
        k_eff = self._k_host(t)[ids]
        return k_eff, stages.delivered_weights(cw, k_eff, k_c)

    def _run_pop_round(self, t: int, hist: History) -> None:
        """The chunk_rounds=1 cohort path: one round, one host sync."""
        lam = self._lam(t)
        round_fn = self._pop_round_fn()
        ids, cw = self.population.host_cohort(t)
        k_c, cw = self._cohort_k(t, ids, cw)
        batches = (self.batcher.sample_cohort(t, ids, self.k_max)
                   if self._device_sampler
                   else self.batcher.cohort_batches(t, ids, self.k_max))
        last = engine.stacked_lasts(ids[None], self.device)
        noise = self._noise(1, ids[None])
        t0 = time.perf_counter()
        # the run owns its state: the ν⁽ⁱ⁾ store is updated in place
        self.state, metrics = round_fn(
            self.state, batches, self._on_device(ids, torch.int64),
            self._on_device(k_c, torch.int32),
            self._on_device(cw, torch.float32), lam, donate=True,
            last=None if last is None else last[0],
            noise=None if noise is None else noise[0])
        self._sync()
        hist.wall.append(time.perf_counter() - t0)
        self._record_metrics(hist, metrics, 1)
        self._record_dropped(hist, t, 1)
        self._record_bytes(hist, 1, self.population.cohort_size)

    def _run_pop_chunk(self, t0: int, r: int, hist: History) -> None:
        chunk_fn = self._pop_chunk_fn(r)
        lams = [self._lam(t0 + j) for j in range(r)]
        if self._device_sampler:
            # cohorts, k′ rows and batches are drawn in the chunk; the host
            # hands over the round indices and the scheduled K rows
            k_rows = np.stack([self._sched_row(t0 + j) for j in range(r)])
            tic = time.perf_counter()
            self.state, metrics = chunk_fn(
                self.state, list(range(t0, t0 + r)), k_rows, lams,
                noise_fn=lambda cohorts: self._noise(r, cohorts))
            self._sync()
            self._record_chunk(hist, metrics, t0, r, tic)
            return
        drawn = [self.population.host_cohort(t0 + j) for j in range(r)]
        cohorts = np.stack([ids for ids, _ in drawn])
        ks, cws = zip(*(self._cohort_k(t0 + j, ids, w)
                        for j, (ids, w) in enumerate(drawn)))
        ks, cws = np.stack(ks), np.stack(cws)
        batches = self.batcher.chunk_cohort_batches(t0, cohorts, self.k_max)
        lasts = engine.stacked_lasts(cohorts, self.device)
        noise = self._noise(r, cohorts)
        tic = time.perf_counter()
        self.state, metrics = chunk_fn(
            self.state, batches, self._on_device(cohorts, torch.int64),
            self._on_device(ks, torch.int32),
            self._on_device(cws, torch.float32), lams, lasts, noise=noise)
        self._sync()
        self._record_chunk(hist, metrics, t0, r, tic)

    def _record_chunk(self, hist: History, metrics: dict, t0: int, r: int,
                      tic: float) -> None:
        dt = time.perf_counter() - tic
        self._record_metrics(hist, metrics, r)
        hist.wall.extend([dt / r] * r)
        self._record_dropped(hist, t0, r)
        self._record_bytes(hist, r, self.population.cohort_size)

    def run(self, t_rounds: int, eval_every: int = 1,
            verbose: bool = False,
            chunk_rounds: Optional[int] = None,
            publish_fn: Optional[Callable[[dict], None]] = None,
            publish_every: int = 0) -> History:
        """``chunk_rounds=None`` chunks at the eval cadence (``eval_every``);
        ``1`` forces the per-round loop.  Chunks never cross an eval
        boundary, so an explicit ``chunk_rounds`` larger than ``eval_every``
        is clamped when there is an ``eval_fn`` or ``eval_per_client``.

        ``publish_fn(snapshot)`` fires every ``publish_every`` rounds with
        ``publish_snapshot()``; chunks never cross a publish boundary
        either, so a publication sees the exact round state."""
        publishes = publish_fn is not None and publish_every > 0
        evaluates = (self.eval_fn is not None
                     or self.eval_per_client is not None)
        chunk = max(int(chunk_rounds if chunk_rounds is not None
                        else eval_every), 1)
        if chunk_rounds is not None and chunk > eval_every and evaluates:
            warnings.warn(
                f"chunk_rounds={chunk_rounds} is clamped to the eval "
                f"cadence (eval_every={eval_every}): the host must sync at "
                f"every eval boundary", stacklevel=2)
        hist = History()
        t = 0
        while t < t_rounds:
            r = min(chunk, t_rounds - t)
            if evaluates:
                r = min(r, eval_every - t % eval_every)
            if publishes:
                r = min(r, publish_every - t % publish_every)
            if self._partial and r == 1:
                self._run_pop_round(t, hist)
            elif self._partial:
                self._run_pop_chunk(t, r, hist)
            elif r == 1:
                self._run_round(t, hist)
            else:
                self._run_chunk(t, r, hist)
            t += r
            if publishes and t % publish_every == 0:
                publish_fn(self.publish_snapshot())
            if t % eval_every == 0:
                if self.eval_fn is not None:
                    value = float(self.eval_fn(self.params))
                    _check_finite_metric(value, t)
                    hist.metric.append(value)
                if self.eval_per_client is not None:
                    hist.per_client.append(
                        [float(v) for v in
                         self.eval_per_client(self.params)])
            if verbose and (t % 10 < r or t == t_rounds):
                m = hist.metric[-1] if hist.metric else float("nan")
                print(f"  round {t - 1:4d}  loss={hist.loss[-1]:.4f}  "
                      f"metric={m:.4f}")
        return hist

    @property
    def params(self) -> PyTree:
        """Current global model as a tree: the state's own on the tree
        layout (the rounds replace it, never write it), new tensors that
        own their data on the flat layout."""
        if self.layout == "flat":
            return flat.unravel(self._spec, self.state["params"])
        return self.state["params"]

    @property
    def flat_spec(self) -> flat.FlatSpec:
        """The ``FlatSpec`` of this model's ``(P,)`` layout.  A flat run,
        and a tree run with wire stages, already own one; a plain tree run
        builds it on first use (shape metadata: the state is untouched)."""
        if self._spec is None:
            self._spec = flat.make_flat_spec(self.state["params"])
        return self._spec

    def publish_snapshot(self) -> dict:
        """A versioned serving snapshot of the current training state: the
        ``(P,)`` flat master and, for algorithms that keep one, the
        calibration signal (ν and the ``(M, P)`` ν⁽ⁱ⁾ rows), a tree state
        raveled through ``flat_spec``.  Version = the state's round
        counter.  The snapshot owns its buffers: the next rounds update the
        state's in place."""
        def own(key: str, client_dims: int = 0) -> torch.Tensor:
            v = self.state[key]
            return (v.clone() if self.layout == "flat"
                    else flat.ravel(self.flat_spec, v, client_dims))

        snap = {"version": np.int32(int(self.state["round"])),
                "flat_master": own("params")}
        if self.algo.uses_nu and "nu" in self.state:
            snap["nu"] = own("nu")
            snap["nu_i"] = own("nu_i", 1)
        return snap

    def save_snapshot(self, path: str) -> dict:
        """Publish and write the snapshot to ``path`` (checkpoint format)."""
        snap = self.publish_snapshot()
        serialize.save(path, snap)
        return snap


def compare_algorithms(algorithms: list[str], make_sim: Callable[[str],
                       FederatedSimulation], t_rounds: int,
                       eval_every: int = 1) -> dict[str, History]:
    """Run the same task under several algorithms (benchmark helper)."""
    out = {}
    for name in algorithms:
        sim = make_sim(name)
        out[name] = sim.run(t_rounds, eval_every=eval_every)
    return out
