"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427;
unverified].

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000.
Period-3 pattern [recurrent, recurrent, local-attn] (Griffin 1:2 ratio):
12 scanned super-blocks + 2 tail recurrent layers = 38.  Local window 2048
bounds attention; RG-LRU state is O(1) in sequence, so long_500k runs.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    d_ff=12288,
    vocab=256_000,
    head_dim=256,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    attn_pattern="griffin_1_2",
    local_window=2048,
    rnn_width=4096,
    conv_kernel=4,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=5,           # 1 super-block + 2 tail layers (exercises the tail)
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    attn_pattern="griffin_1_2",
    local_window=16,
    rnn_width=64,
    conv_kernel=4,
)
