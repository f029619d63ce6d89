#!/usr/bin/env python3
"""Training steps of full-width configs on one GPU at several depths: how
deep each trains in the card's memory with finite gradients.

Run from the repository root:

    python3 tools/train_depth.py ARCH:LAYERS [ARCH:LAYERS ...]
    python3 tools/train_depth.py rwkv6-7b:12 rwkv6-7b:14 recurrentgemma-9b:8

For each ARCH:LAYERS, in a process of its own (so that running out of
memory at one depth leaves the next untouched): ``launch.train.run`` at full
width cut to LAYERS layers, bf16 compute over f32 master weights,
``remat="full"``, 2 steps of 4 x 1024 tokens of
``SyntheticTokenPipeline(seed=0)``.  One JSON line each: the losses and
grad norms, whether all are finite, each step's seconds, the peak device
memory (``torch.cuda.max_memory_allocated``), or the error that ended the
run (out of memory).  The first line is the card's name and power limit.
This finds the depths ``chip_smoke.py``'s ``[train]`` takes
(``TRAIN_RECURRENT``).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(arch: str, layers: int) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.launch import train as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    args = launch.parser().parse_args(
        ["--device", "cuda", "--arch", arch, "--full", "--layers",
         str(layers), "--steps", "2", "--batch", "4", "--seq", "1024",
         "--ckpt-every", "0", "--log-every", "10", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    try:
        out = launch.run(args)
    except torch.cuda.OutOfMemoryError as exc:
        return {"arch": arch, "layers": layers, "error": str(exc)[:200],
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return {"arch": arch, "layers": layers, "losses": out["losses"],
            "grad_norms": out["grad_norms"],
            "finite": all(math.isfinite(x)
                          for x in out["losses"] + out["grad_norms"]),
            "step_s": out["step_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1], int(argv[2]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode != 0:
        print("train_depth: no GPU", file=sys.stderr)
        return 2
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for spec in argv:
        arch, layers = spec.rsplit(":", 1)
        run = subprocess.run([sys.executable, __file__, "--one", arch,
                              layers], capture_output=True, text=True)
        lines = run.stdout.strip().splitlines()
        if run.returncode != 0 or not lines:
            rc = 1
            print(json.dumps({"arch": arch, "layers": int(layers),
                              "returncode": run.returncode,
                              "stderr": run.stderr[-600:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
