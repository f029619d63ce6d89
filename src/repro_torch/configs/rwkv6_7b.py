"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free, 64 heads × head_dim 64) d_ff=14336
vocab=65536.  Matrix-state recurrence: O(1) state in sequence length, so
long_500k runs.  The paper's attention-sharding concerns are inapplicable —
the scheduler treats instances identically (DESIGN.md §5).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # d_model / 64 rwkv head size
    n_kv=64,
    d_ff=14336,
    vocab=65_536,
    head_dim=64,
    attn_pattern="rwkv",
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,          # 2 rwkv heads of 64
    n_heads=2,
    n_kv=2,
    d_ff=256,
    vocab=512,
    head_dim=64,
    attn_pattern="rwkv",
)
