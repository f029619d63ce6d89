"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8,
qk-norm (OLMoE uses QK-Norm).  64 experts divide the 16-way model axis ->
true expert parallelism (4 experts/shard).
"""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50_304,
    head_dim=128,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8),
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=64,
    vocab=512,
    head_dim=16,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=4),
)
