"""MusicGen-medium decoder backbone over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144 vocab=2048, 4 codebooks.
The mel/EnCodec frontend is a stub per the carve-out: input_specs() provides
codebook token ids directly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    glu=False,
    norm="ln",
    frontend="audio",
    n_codebooks=4,
    tie_embeddings=False,
    source="arXiv:2306.05284",
)
