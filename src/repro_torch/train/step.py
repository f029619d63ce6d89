"""The train step: gradients of the loss, microbatch accumulation, AdamW.

The reference's ``repro.train.step`` in PyTorch.  The train state holds the
parameters as an f32 master tree and the optimizer's ``m``, ``v`` and
``step``; ``ModelApi.loss`` casts a working copy of the master each step
(the leaves the reference uses in f32 stay f32), so the gradients arrive on
the master leaves in f32.  Microbatch gradients are summed in f32 from
zeros, then divided by ``accum_steps``; the loss and every aux metric are
averaged the same way.  ``make_train_step`` returns a function that
updates the state in place and returns it with its metrics (0-d tensors on
the state's device).

On CUDA a step runs under ``torch.use_deterministic_algorithms`` (the
embedding's gradient is a scatter-add whose default CUDA kernel adds in
no fixed order), so that the same state and batch give bit-identical
gradients: the restart from a checkpoint is held to that.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.models.api import ModelApi
from repro_torch.models.convert import master_params

from .optim import OptConfig, adamw_update, init_opt_state, tree_leaves, \
    tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1          # microbatch gradient accumulation


def init_train_state(api: ModelApi, seed: int) -> dict:
    """The f32 master tree of the port's seeded ``api.init`` and a fresh
    optimizer state."""
    params = master_params(api.init(seed))
    return {"params": params, "opt": init_opt_state(params)}


def _split_microbatches(batch: dict, accum: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % accum == 0, f"batch {b} not divisible by accum {accum}"
        return x.reshape(accum, b // accum, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic kernels for the duration (on CUDA; the CPU's are)."""
    if device.type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def value_and_grad(api: ModelApi, params: Any, batch: dict
                   ) -> tuple[tuple[torch.Tensor, dict], Any]:
    """((loss, aux), grads) of ``api.loss`` at ``params`` (a master tree,
    left as it is), the gradients an f32 tree of the same structure."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_()
        leaves.append(leaf)
        return leaf

    tracked = tree_map(track, params)
    dev = leaves[0].device
    with torch.enable_grad(), deterministic(dev):
        loss, aux = api.loss(tracked, batch)
        grads = iter([g.float() for g in torch.autograd.grad(loss, leaves)])
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree_map(lambda _: next(grads), params)


def make_train_step(api: ModelApi, tcfg: TrainConfig):
    """(state, batch) -> (state, metrics): the gradients of ``batch`` (in
    ``accum_steps`` microbatches), then AdamW on the state in place.
    ``metrics`` holds ``loss``, ``grad_norm``, ``lr`` and the loss's aux."""
    def train_step(state: dict, batch: dict):
        params = state["params"]
        if tcfg.accum_steps == 1:
            (loss, aux), grads = value_and_grad(api, params, batch)
        else:
            mbs = _split_microbatches(batch, tcfg.accum_steps)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            auxs = []
            for i in range(tcfg.accum_steps):
                (l, a), g = value_and_grad(
                    api, params, {k: v[i] for k, v in mbs.items()})
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc += gi
                loss = loss + l
                auxs.append(a)
            for acc in tree_leaves(grads):
                acc /= tcfg.accum_steps
            loss = loss / tcfg.accum_steps
            aux = {k: torch.stack([a[k] for a in auxs]).mean(dim=0)
                   for k in auxs[0]}
        _, _, om = adamw_update(tcfg.opt, params, grads, state["opt"])
        return state, {"loss": loss, **om, **aux}

    return train_step
