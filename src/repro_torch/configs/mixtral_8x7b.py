"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding-window attention (window 4096) -> bounded KV cache, so long_500k runs.
"""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32_000,
    head_dim=128,
    swa_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=96,
    vocab=512,
    head_dim=16,
    swa_window=16,
    moe=MoEConfig(num_experts=4, top_k=2),
)
