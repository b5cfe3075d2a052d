"""Qwen2-VL-2B [arXiv:2409.12191]: 28L d=1536 12H (kv=2) ff=8960
vocab=151936, M-RoPE (t/h/w sections), dynamic resolution. The ViT/SigLIP
vision encoder + projector is a stub per the carve-out: input_specs()
provides precomputed patch embeddings + 3D position grids."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vision",
    mrope_sections=(16, 24, 24),   # t/h/w halves of head_dim=128 rotary dims
    source="arXiv:2409.12191",
)
