"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4, head_dim 128) d_ff=18944 vocab=152064.
28 query heads over 4 KV heads: 7 query heads share each KV head.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv=4,
    d_ff=18944,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=56,
    n_heads=7,
    n_kv=1,
    d_ff=128,
    vocab=512,
    head_dim=8,
    qkv_bias=True,
)
