"""Quickstart on the PyTorch/CUDA port: train a tiny LM end to end.

The same run as ``examples/quickstart.py`` (the smoke llama3.2-1b, AdamW at
lr 2e-3 with 10 warm-up steps, 60 steps of 8 x 64 synthetic tokens) through
the port's train step: an f32 master tree, the loss on its working copy,
every attention and its backward through K4 (on the card unless
``--device cpu``).

    python examples/torch_quickstart.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.models import build_model, count_params  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               init_train_state, make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    cfg = get_config("llama3.2-1b", smoke=True)
    api = build_model(cfg, device=args.device)
    state = init_train_state(api, 0)
    print(f"model: {cfg.name}  params: {count_params(state['params']):,}")

    tcfg = TrainConfig(opt=OptConfig(lr=2e-3, warmup_steps=10,
                                     total_steps=100))
    step = make_train_step(api, tcfg)
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                             global_batch=8, seed=0))
    first = None
    for i in range(args.steps):
        batch = {"tokens": torch.as_tensor(
            data.batch_at(i)["tokens"]).to(api.device)}
        state, m = step(state, batch)
        if first is None:
            first = float(m["loss"])
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}")
    final = float(m["loss"])
    print(f"loss {first:.3f} -> {final:.3f} "
          f"({'LEARNING' if final < first - 0.2 else 'check config'})")
    return {"first_loss": first, "final_loss": final}


if __name__ == "__main__":
    main()
