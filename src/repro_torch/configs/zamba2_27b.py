"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + weight-shared attention
block interleaved. 54L d=2560 32H (kv=32) ff=10240 vocab=32000 ssm_state=64."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    hybrid_attn_every=6,
    hybrid_shared_attn=True,
    source="arXiv:2411.15242",
)
