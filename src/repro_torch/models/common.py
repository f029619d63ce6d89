"""Shared model building blocks (PyTorch, functional param-dict style).

Every layer is a pair of functions: ``*_init(gen, ...) -> params`` (a dict of
tensors made from an explicit ``torch.Generator``) and an apply function
taking (params, x, ...), as in the reference ``repro.models``.  Blocks are a
list of per-layer dicts run in a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

Params = Any  # nested dict of tensors; "blocks" is a list of per-layer dicts


# ---------------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dispatch: str = "global"             # global | per_sequence | shard_map
    constrain_ffn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's configuration, field for field, with torch dtypes.

    The sharding and rematerialisation fields (``remat``, ``attn_chunk_q``,
    ``seq_shard``, ``moe_zero1``, ``zero1``) are kept so that every config
    carries over; one device reads none of them.  On every full-sequence
    attention the flash-attention kernel takes the place of
    ``attn_chunk_q``."""
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qkv_bias: bool = False               # qwen1.5 / qwen2
    qk_norm: bool = False                # qwen3
    swa_window: int | None = None        # mixtral sliding-window
    local_window: int | None = None      # recurrentgemma local attention
    moe: MoEConfig | None = None
    act: str = "silu"                    # silu (swiglu) | gelu (geglu) | relu
    tie_embeddings: bool = False
    scale_embed: bool = False            # gemma-style sqrt(d) embedding scale
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    enc_layers: int = 0
    dec_layers: int = 0
    attn_pattern: str = "all"            # all | griffin_1_2 | rwkv
    rnn_width: int | None = None
    conv_kernel: int = 4
    frontend: str | None = None          # None | patch | frames
    frontend_len: int = 256
    prefix_lm: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"
    attn_chunk_q: int | None = None
    seq_shard: bool = False
    moe_zero1: bool = False
    zero1: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def validate(self) -> None:
        if self.n_kv and self.n_heads % self.n_kv:
            raise ValueError(f"{self.name}: {self.n_heads} heads do not "
                             f"divide into {self.n_kv} KV heads")


# ---------------------------------------------------------------------------------
# Initializers / primitive layers
# ---------------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    t = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (t * d ** -0.5).to(dtype)


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the biased variance, cast back to x's dtype
    (no model of the reference calls it; it is public there and here)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dt)


ACTIVATIONS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


# ---------------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    # theta as an f32 tensor made on the device: no host-to-device copy
    return 1.0 / torch.full_like(exps, theta).pow(exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # [hd/2]
    angles = positions[..., None].float() * freqs               # [..., S, hd/2]
    sin = torch.sin(angles)[..., None, :]                       # [..., S, 1, hd/2]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def count_params(params: Params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)
