"""AdamW optimizer + LR schedule + global-norm clipping (no external deps).

The reference's ``repro.train.optim`` in PyTorch, with the same arithmetic
in f32: the optimizer state mirrors the parameter tree (``m``, ``v`` and an
int32 ``step``), and ``adamw_update`` updates the parameters and the state
in place under ``torch.no_grad()`` where the reference returns new trees.
A tree is a nest of dicts and per-layer lists of tensors (the port's
params); its leaves are visited in insertion order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for val in vals for leaf in tree_leaves(val)]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return [tree_map(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(tree)]


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an f32 0-d
    tensor computed as the reference's ``jnp`` expression computes it in
    f32: linear warm-up, then a cosine to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Any) -> dict:
    """Zero ``m`` and ``v`` (f32, shaped as the parameters) and step 0."""
    def zeros(p): return torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
    leaves = tree_leaves(params)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device if leaves else None)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any,
                                                              torch.Tensor]:
    """(the gradients in f32 times min(1, max_norm / norm), the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Any, grads: Any, opt_state: dict
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step with global-norm clipping, in place: ``params`` and
    ``opt_state`` are updated and returned, with metrics ``grad_norm`` (the
    norm before clipping) and ``lr``."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    opt_state["step"] += 1
    step = opt_state["step"]
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        p.sub_((lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * p)).to(p.dtype))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
