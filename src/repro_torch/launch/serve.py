"""Serving entry point: batched requests through prefill + decode.

    python -m repro_torch.launch.serve [--arch llama3.2-1b] [--full]
                                       [--device cuda|cpu]

One *instance* in the paper's co-location model, on one device (the card
unless ``--device cpu``).  The weights come from the port's own seeded
init; the smoke config is the default, ``--full`` serves the config's full
width and depth.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    api = build_model(cfg, device=args.device)
    params = api.init(args.seed)
    engine = ServeEngine(api, params, batch_size=args.batch, seq_len=args.seq)
    if api.device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(api.device)}")
    else:
        print("device: cpu")

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab, rng.integers(8, args.seq),
                                    dtype=np.int32),
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    toks = engine.stats["tokens"]
    print(f"served {len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    dec = engine.stats["decode_s"]
    if dec:
        print(f"decode p50 {1e3 * np.percentile(dec, 50):.1f}ms "
              f"p90 {1e3 * np.percentile(dec, 90):.1f}ms")
    for r in reqs[:2]:
        print(f"req {r.rid}: {r.output[:8]}...")


if __name__ == "__main__":
    main()
