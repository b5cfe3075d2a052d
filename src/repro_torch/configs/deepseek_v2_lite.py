"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434]: 27L d=2048 16H MLA kv_lora=512,
per-expert ff=1408, 64 routed experts top-6 + 2 shared, vocab=102400."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)
