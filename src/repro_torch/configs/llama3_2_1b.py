"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

16L d_model=2048 32H (GQA kv=8, head_dim 64) d_ff=8192 vocab=128256,
tied embeddings, rope theta 500k.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    d_ff=8192,
    vocab=128_256,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    tie_embeddings=True,
)
