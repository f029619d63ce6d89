#!/usr/bin/env python3
"""paligemma-3b's loss and gradients on one GPU at several depths, fed the
training launcher's zero patch embeddings.

Run from the repository root:

    python3 tools/vlm_depth.py [LAYERS ...]        # default 6 8 10 12 14

For each depth: the full-width config cut to that many layers, seeded
random f32 master weights, bf16 compute, one ``value_and_grad`` on 4 x 1024
tokens of ``SyntheticTokenPipeline(seed=0)`` behind 256 zero patch
embeddings (``launch.train.feed``).  One JSON line each: the loss, whether
every gradient is finite, the global gradient norm (f64 on the host), the
largest gradient element and the peak device memory.  The first line is
the card's name and power limit.

With zero patch embeddings the prefix positions' residual stays exactly 0
at every layer, where rmsnorm's gradient is eps^-0.5; the gradient that
reaches those positions grows with every layer it passes and, past some
depth, overflows and turns the norms' gradients NaN.  This finds the
depth ``chip_smoke.py``'s ``[train]`` can take (``TRAIN_VLM_LAYERS``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import train as launch
    from repro_torch.models import build_model, master_params
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import value_and_grad

    if not torch.cuda.is_available():
        print("vlm_depth: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    base = get_config("paligemma-3b")
    data = SyntheticTokenPipeline(DataConfig(vocab=base.vocab, seq_len=1024,
                                             global_batch=4, seed=0))
    for layers in [int(a) for a in argv] or [6, 8, 10, 12, 14]:
        cfg = dataclasses.replace(base, n_layers=layers)
        api = build_model(cfg, device="cuda")
        master = master_params(api.init(0))
        batch = launch.feed(cfg, api, data.batch_at(0)["tokens"], 4, 1024)
        torch.cuda.reset_peak_memory_stats()
        (loss, _), grads = value_and_grad(api, master, batch)
        leaves = tree_leaves(grads)
        print(json.dumps({
            "layers": layers, "loss": float(loss),
            "finite": all(bool(torch.isfinite(g).all()) for g in leaves),
            "grad_norm": math.sqrt(sum(float(g.double().square().sum())
                                       for g in leaves)),
            "max_grad": max(float(g.abs().max()) for g in leaves),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}),
              flush=True)
        del master, grads, api, leaves
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
