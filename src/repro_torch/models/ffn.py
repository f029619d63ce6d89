"""Feed-forward layers: gated MLP (SwiGLU/GeGLU), plain (relu) MLP, and the
top-k MoE.

The MoE uses the reference's sort-based capacity dispatch: tokens are
sorted by expert id (stably), placed into per-expert capacity slots of a
dense ``[E + 1, C, d]`` buffer whose last row takes the dropped tokens,
processed with one batched product per projection, and combined with their
router gates.  Tokens beyond an expert's capacity are dropped, and which
ones are dropped depends on the token order, so the serving path's
left-padding is part of the routing as in the reference.  The expert
products stay ``torch.bmm``: the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from .common import ACTIVATIONS, ModelConfig, dense_init


# ---------------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> dict:
    d, f, cd = cfg.d_model, d_ff or cfg.d_ff, cfg.compute_dtype
    if cfg.act == "relu":  # non-gated (classic transformer)
        return {
            "w_in": dense_init(gen, (d, f), dtype=cd),
            "w_out": dense_init(gen, (f, d), dtype=cd),
        }
    return {
        "w_gate": dense_init(gen, (d, f), dtype=cd),
        "w_up": dense_init(gen, (d, f), dtype=cd),
        "w_down": dense_init(gen, (f, d), dtype=cd),
    }


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    if "w_in" in p:
        return act(x @ p["w_in"]) @ p["w_out"]
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router in f32 (the reference routes in f32), the experts in the
    compute dtype."""
    d, f, E, cd = cfg.d_model, cfg.d_ff, cfg.moe.num_experts, cfg.compute_dtype
    return {
        "router": dense_init(gen, (d, E)),
        "w_gate": dense_init(gen, (E, d, f), dtype=cd),
        "w_up": dense_init(gen, (E, d, f), dtype=cd),
        "w_down": dense_init(gen, (E, f, d), dtype=cd),
    }


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    moe = cfg.moe
    c = int(num_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)  # a multiple of 8, as the reference


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, S, d] -> ([B, S, d], aux) with the load-balance stats.

    ``"per_sequence"`` dispatches each sequence on its own (capacity from
    its S tokens) and averages the aux over the batch.  ``"global"`` and
    ``"shard_map"`` dispatch all B * S tokens together: the reference's
    shard_map island is the global dispatch when no batch axes are set,
    which is always the case in one process."""
    if cfg.moe.dispatch == "per_sequence" and x.shape[0] > 1:
        outs, auxs = zip(*(_moe_tokens(p, cfg, xb[None]) for xb in x))
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return torch.cat(outs), aux
    return _moe_tokens(p, cfg, x)


def moe_route(p, cfg: ModelConfig, xf: torch.Tensor) -> dict:
    """The routing of T tokens ``xf`` [T, d]: router probabilities, the top
    k experts and gates of each token, and each (token, expert) slot's
    place in the capacity buffer.

    Top k is the first k of a stable descending sort (ties to the lower
    expert index, as ``lax.top_k``; ``torch.topk`` on CUDA promises no
    order among ties), and the slots are sorted by expert stably, as
    ``jnp.argsort``.  A dropped slot goes to the dummy row E at position
    C - 1, as in the reference."""
    moe = cfg.moe
    T = xf.shape[0]
    E, k = moe.num_experts, moe.top_k
    C = moe_capacity(cfg, T)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_e = expert_idx.reshape(-1)                              # [T*k]
    flat_tok = torch.arange(T, device=xf.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)                 # [E]
    excl = torch.cumsum(counts, 0) - counts                      # exclusive
    pos_in_e = torch.arange(T * k, device=xf.device) - excl[sorted_e]
    keep = pos_in_e < C
    return {
        "probs": probs, "gate_vals": gate_vals, "expert_idx": expert_idx,
        "order": order, "sorted_tok": flat_tok[order], "counts": counts,
        "keep": keep, "capacity": C,
        "e_safe": torch.where(keep, sorted_e, E),
        "pos_safe": torch.where(keep, pos_in_e, C - 1),
    }


def _moe_tokens(p, cfg: ModelConfig, x: torch.Tensor):
    """The dispatch of all B * S tokens of ``x`` together: (out, aux)."""
    cd = cfg.compute_dtype
    B, S, d = x.shape
    T = B * S
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    xf = x.reshape(T, d)
    r = moe_route(p, cfg, xf)
    C, e_safe, pos_safe, keep = (r["capacity"], r["e_safe"], r["pos_safe"],
                                 r["keep"])

    buf = torch.zeros((E + 1, C, d), dtype=cd, device=x.device)
    buf[e_safe, pos_safe] = xf[r["sorted_tok"]].to(cd)
    act = ACTIVATIONS[cfg.act]
    g = act(torch.bmm(buf[:E], p["w_gate"]))
    u = torch.bmm(buf[:E], p["w_up"])
    out_buf = torch.cat([torch.bmm(g * u, p["w_down"]),
                         torch.zeros((1, C, d), dtype=cd, device=x.device)])

    gathered = out_buf[e_safe, pos_safe] * keep[:, None].to(cd)
    y_flat = torch.empty_like(gathered)
    y_flat[r["order"]] = gathered                    # back to [T*k, d]
    y = (y_flat.reshape(T, k, d)
         * r["gate_vals"].reshape(T, k, 1).to(cd)).sum(dim=1)

    # aux: the Switch-style load-balancing term and the drop fraction
    me = r["probs"].mean(dim=0)
    ce = r["counts"].float() / (T * k)
    aux = {
        "load_balance_loss": E * torch.sum(me * ce),
        "dropped_fraction": 1.0 - keep.float().mean(),
    }
    return y.reshape(B, S, d), aux
