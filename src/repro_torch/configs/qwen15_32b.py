"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family]: 64L d=5120 40H (kv=40)
ff=27392, vocab=152064, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152_064,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
