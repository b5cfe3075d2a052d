"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite, gemma3_12b, gemma_2b,
                           granite_moe_1b, llama3_8b, musicgen_medium,
                           qwen15_32b, qwen2_vl_2b, xlstm_125m, zamba2_27b)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        musicgen_medium.CONFIG,
        gemma_2b.CONFIG,
        qwen15_32b.CONFIG,
        granite_moe_1b.CONFIG,
        zamba2_27b.CONFIG,
        gemma3_12b.CONFIG,
        xlstm_125m.CONFIG,
        deepseek_v2_lite.CONFIG,
        qwen2_vl_2b.CONFIG,
        llama3_8b.CONFIG,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
