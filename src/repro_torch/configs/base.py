"""Model and federated round configuration — the port's copy of
``repro``'s ``ModelConfig`` (with its sub-configs and ``reduced``) and
``FedConfig``, with the same field names and defaults so one config reads
the same in both packages.  Every architecture is a ``ModelConfig`` in one
file of this package (``registry.py`` lists them).

Every ``FedConfig`` field's feature runs in the port's engines, on both
parameter layouts ("tree", the default, and "flat"), and the same values
are refused as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Literal


BlockKind = Literal["attn", "mamba2", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # decode-time weight absorption (§Perf #5): score/output matmuls run in
    # the compressed latent space instead of up-projecting the whole cache
    # per token.  False = paper-faithful naive decode (the A/B baseline).
    absorb: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4           # one sLSTM per this many blocks
    proj_factor: float = 2.0       # up-projection inside mLSTM
    conv_dim: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    act: Literal["silu", "gelu", "relu"] = "silu"
    glu: bool = True
    qkv_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm: Literal["rms", "ln"] = "rms"
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    max_seq: int = 131_072
    # -- sliding window / local-global pattern (gemma3) ---------------------
    sliding_window: int = 0        # 0 => all-global full attention
    global_every: int = 0          # e.g. 6 => layers 5,11,... are global
    attn_logit_softcap: float = 0.0
    # -- architecture-specific sub-configs ----------------------------------
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    # -- hybrid layout (zamba2): attn block shared + every N ssm layers ------
    hybrid_attn_every: int = 0     # 0 => not hybrid
    hybrid_shared_attn: bool = True
    # -- modality frontends (stubs per the carve-out) ------------------------
    frontend: Literal["none", "audio", "vision"] = "none"
    n_codebooks: int = 0           # musicgen: EnCodec codebooks
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl: (t, h, w) rope splits
    # -- numerics ------------------------------------------------------------
    dtype: str = "float32"         # activation / param dtype for this config
    remat: bool = True
    scan_layers: bool = True
    source: str = ""               # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_pattern(self) -> list[BlockKind]:
        """Per-layer block kinds, grouped later into scanned segments."""
        if self.family == "hybrid" and self.hybrid_attn_every:
            out: list[BlockKind] = []
            for i in range(self.n_layers):
                out.append("mamba2")
                if (i + 1) % self.hybrid_attn_every == 0:
                    out.append("attn")
            return out
        if self.xlstm is not None:
            k = self.xlstm.slstm_every
            return ["slstm" if (i + 1) % k == 0 else "mlstm"
                    for i in range(self.n_layers)]
        if self.family == "ssm" and self.ssm is not None and self.xlstm is None:
            return ["mamba2"] * self.n_layers
        return ["attn"] * self.n_layers

    def is_global_layer(self, idx: int) -> bool:
        """Sliding-window pattern: True if layer attends globally."""
        if self.sliding_window == 0:
            return True
        if self.global_every == 0:
            return False
        return (idx + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, v = self.d_model, self.vocab
        total = v * d if self.tie_embeddings else 2 * v * d
        if self.frontend == "audio" and self.n_codebooks:
            total += (self.n_codebooks - 1) * v * d          # extra cb embeds
            total += (self.n_codebooks - 1) * v * d          # extra heads
        hd = self.resolved_head_dim
        for i, kind in enumerate(self.layer_pattern()):
            if kind == "attn":
                if self.hybrid_attn_every and self.hybrid_shared_attn and i != self.layer_pattern().index("attn"):
                    continue                                  # weight-shared
                total += self._attn_params(hd) + self._mlp_params() + 2 * d
            elif kind == "mamba2":
                total += self._mamba_params() + d
                if not self.hybrid_attn_every:
                    total += self._mlp_params() + d if self.d_ff else 0
            elif kind == "mlstm":
                total += self._mlstm_params() + d
            elif kind == "slstm":
                total += self._slstm_params() + d
        return total

    def _attn_params(self, hd: int) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            q = d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            kv_down = d * (m.kv_lora_rank + m.qk_rope_head_dim)
            kv_up = m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            o = self.n_heads * m.v_head_dim * d
            return q + kv_down + kv_up + o
        qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads)
        if self.qkv_bias:
            qkv += hd * (self.n_heads + 2 * self.n_kv_heads)
        return qkv + self.n_heads * hd * d

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            per = (3 if self.glu else 2) * d * m.d_ff
            return d * m.n_experts + (m.n_experts + m.n_shared_experts) * per
        if self.d_ff == 0:
            return 0
        return (3 if self.glu else 2) * d * self.d_ff

    def _mamba_params(self) -> int:
        assert self.ssm is not None
        s = self.ssm
        d_in = s.expand * self.d_model
        nh = d_in // s.head_dim
        in_proj = self.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
        conv = s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
        return in_proj + conv + 2 * nh + d_in + d_in * self.d_model

    def _mlstm_params(self) -> int:
        assert self.xlstm is not None
        d = self.d_model
        d_in = int(self.xlstm.proj_factor * d)
        hd = d_in // self.n_heads
        return d * 2 * d_in + d_in * 3 * d_in + 3 * self.n_heads * d_in // max(hd, 1) + d_in * d + d_in

    def _slstm_params(self) -> int:
        d = self.d_model
        return 4 * d * d + 4 * d * d + 8 * d + (3 if self.glu else 2) * d * (d * 4 // 3)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per = (3 if self.glu else 2) * self.d_model * m.d_ff
        dense_like = self.param_count() - self.n_layers * (m.n_experts + m.n_shared_experts) * per
        return dense_like + self.n_layers * (m.top_k + m.n_shared_experts) * per


def __getattr__(name: str):
    """``SCENARIOS`` and ``DEFENSES``: the registries themselves
    (fed/scenarios.py, core/robust.py), imported on first use — they live
    downstream of this module."""
    if name == "SCENARIOS":
        from repro_torch.fed.scenarios import SCENARIOS
        return SCENARIOS
    if name == "DEFENSES":
        from repro_torch.core.robust import DEFENSES
        return DEFENSES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    # -- buffered semi-asynchronous execution (fed/async_engine.py) ---------
    buffer_size: int = 0
    staleness: Literal["constant", "hinge", "poly"] = "constant"
    staleness_a: float = 0.5
    staleness_b: int = 4
    speed_dist: Literal["fixed", "uniform", "lognormal", "bimodal"] = "lognormal"
    speed_sigma: float = 0.5
    comm_latency: float = 0.0
    # -- partial participation (fed/population.py; synchronous rounds) ----
    cohort_size: int = 0
    cohort_sampler: Literal["all", "uniform", "weighted", "availability",
                            "round_robin"] = "all"
    availability: float = 1.0
    cohort_nu_decay: float = 0.0
    # -- parameter layout: the model's tree, or one flat buffer (core/flat.py)
    param_layout: Literal["tree", "flat"] = "tree"
    master_dtype: Literal["", "float32", "bfloat16", "float16"] = ""
    # -- failure scenarios (fed/scenarios.py) -------------------------------
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
    # -- Byzantine-robust aggregation (core/robust.py) ----------------------
    defense: str = "none"
    defense_clip: float = 0.0
    trim_frac: float = 0.2
    krum_f: int = 1
    nu_defense: bool = True
    quarantine_window: int = 0
    quarantine_z: float = 4.0
    quarantine_nonfinite: int = 1

    def __post_init__(self):
        """Fail at construction on an unknown name, listing the valid ones,
        or on a value out of its range, in the reference's order and with
        its messages (the registries are imported lazily: they live
        downstream).  The deprecated ``quantize_transmit=True`` folds into
        ``compressor="int8"``, as in the reference."""
        import warnings

        from repro_torch.core.compress import COMPRESSORS
        from repro_torch.core.fedopt import ALGORITHMS
        from repro_torch.core.robust import DEFENSES
        from repro_torch.core.stages import SERVER_OPTIMIZERS
        from repro_torch.fed.population import SAMPLERS
        from repro_torch.fed.scenarios import SCENARIOS

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
        _check("cohort_sampler", self.cohort_sampler, SAMPLERS)
        _check("param_layout", self.param_layout, ("tree", "flat"))
        _check("master_dtype", self.master_dtype,
               ("", "float32", "bfloat16", "float16"))
        if self.master_dtype and self.param_layout != "flat":
            raise ValueError(
                f"master_dtype={self.master_dtype!r} requires "
                f"param_layout='flat' (the master buffer IS the flat "
                f"buffer); the tree layout keeps per-leaf dtypes")
        _check("server_opt", self.server_opt, SERVER_OPTIMIZERS)
        _check("scenario", self.scenario, SCENARIOS)
        _check("defense", self.defense, DEFENSES)
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(f"trim_frac {self.trim_frac} not in [0, 0.5) "
                             f"(trimming both tails must leave rows)")
        if self.defense_clip < 0:
            raise ValueError(f"defense_clip must be ≥ 0 (0 = adaptive), "
                             f"got {self.defense_clip}")
        if self.krum_f < 0:
            raise ValueError(f"krum_f must be ≥ 0, got {self.krum_f}")
        if self.quarantine_window < 0:
            raise ValueError(f"quarantine_window must be ≥ 0, "
                             f"got {self.quarantine_window}")
        if self.quarantine_nonfinite < 1:
            raise ValueError(f"quarantine_nonfinite must be ≥ 1, "
                             f"got {self.quarantine_nonfinite}")
        if self.quarantine_z <= 0:
            raise ValueError(f"quarantine_z must be > 0, "
                             f"got {self.quarantine_z}")
        _check("staleness", self.staleness, ("constant", "hinge", "poly"))
        _check("speed_dist", self.speed_dist,
               ("fixed", "uniform", "lognormal", "bimodal", "trace"))
        _check("weights", self.weights, ("uniform", "data"))
        _check("k_mode", self.k_mode, ("fixed", "random"))


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 128,
            max_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family (per instructions)."""
    ratio = max(d_model // 64, 1)
    n_heads = min(cfg.n_heads, max(2, ratio))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    head_dim = d_model // n_heads
    changes: dict = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=0 if cfg.d_ff == 0 else d_model * 4,
        vocab=min(cfg.vocab, vocab), max_seq=4096, dtype="float32",
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        global_every=min(cfg.global_every, 2) if cfg.global_every else 0,
        hybrid_attn_every=min(cfg.hybrid_attn_every, 2) if cfg.hybrid_attn_every else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2), d_ff=d_model * 2,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1))
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=head_dim,
                                   qk_rope_head_dim=16, v_head_dim=head_dim)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                             chunk=16)
    if cfg.xlstm is not None:
        changes["xlstm"] = dataclasses.replace(
            cfg.xlstm, slstm_every=min(cfg.xlstm.slstm_every, n_layers))
    if cfg.mrope_sections:
        changes["mrope_sections"] = _mrope_sections(head_dim)
    return dataclasses.replace(cfg, **changes)


def _mrope_sections(head_dim: int) -> tuple[int, int, int]:
    half = head_dim // 2
    t = half - 2 * (half // 4)
    return (t, half // 4, half // 4)
