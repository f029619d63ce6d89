"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

36L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=12288 vocab=151936,
qk-RMSNorm, no QKV bias.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=12288,
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    qk_norm=True,
)
