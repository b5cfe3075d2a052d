"""Gemma-2B [arXiv:2403.08295]: 18L d=2048 8H MQA(kv=1) GeGLU ff=16384,
head_dim=256, vocab=256000, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256_000,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
