"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936, QKV bias, tied embeds.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=2816,
    vocab=151_936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    qkv_bias=True,
    tie_embeddings=True,
)
