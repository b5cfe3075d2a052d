"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
24L d=1024 16H (kv=8) per-expert ff=512, 32 experts top-8, vocab=49155."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
