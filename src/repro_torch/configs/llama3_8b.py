"""Llama-3-8B [arXiv:2407.21783]: 32L d=4096 32H (kv=8) ff=14336
vocab=128256, GQA, rope_theta=500000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
