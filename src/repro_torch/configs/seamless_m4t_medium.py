"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L (encoder) + 12L (decoder) d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 (padded to 256256 for 16-way vocab sharding).  The audio frame
frontend is a stub: the batch holds precomputed frame embeddings
[B, S, d] for the encoder.  Non-gated ReLU FFN per the NLLB/M4T family.
"""
from repro_torch.models.common import ModelConfig

VOCAB_RAW = 256_206         # paper value; padded so vocab % 16 == 0
VOCAB_PADDED = 256_256

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=VOCAB_PADDED,
    head_dim=64,
    act="relu",
    frontend="frames",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    enc_layers=2,
    dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="relu",
    frontend="frames",
)
