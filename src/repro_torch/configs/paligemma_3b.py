"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1, head_dim 256) d_ff=16384 vocab=257216.
The SigLIP patch frontend is a stub: the batch holds precomputed patch
embeddings [B, 256, d]; the gemma text stack uses prefix-LM masking over the
patch prefix, GeGLU MLP, tied + sqrt(d)-scaled embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_ff=16384,
    vocab=257_216,
    head_dim=256,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    frontend="patch",
    frontend_len=256,
    prefix_lm=True,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    frontend="patch",
    frontend_len=8,
    prefix_lm=True,
)
