"""Gemma3-12B [hf:google/gemma-3-1b-pt family]: 48L d=3840 16H (kv=8)
ff=15360 vocab=262144, 5:1 local:global sliding-window (window 1024), 128k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262_144,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    sliding_window=1024,
    global_every=6,          # layers 6,12,... global -> 5:1 local:global
    rope_theta=1_000_000.0,
    max_seq=131_072,
    source="hf:google/gemma-3-1b-pt",
)
