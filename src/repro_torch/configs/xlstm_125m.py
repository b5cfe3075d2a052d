"""xLSTM-125M [arXiv:2405.04517]: 12L d=768 4H, sLSTM + mLSTM blocks (3:1),
vocab=50304, d_ff=0 (projections live inside the blocks)."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    norm="ln",
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0),
    source="arXiv:2405.04517",
)
