"""Training driver: data pipeline -> train step -> checkpoints, on one device.

    python -m repro_torch.launch.train --arch llama3.2-1b          # smoke
    python -m repro_torch.launch.train --full --batch 4 --seq 1024 # full width
    python -m repro_torch.launch.train --device cpu                # no card

The reference's ``repro.launch.train`` in PyTorch.  The model runs on the
card unless ``--device cpu`` is given; on CUDA every attention and its
backward go through K4's kernels.  Fault tolerance as the reference's:
atomic checkpoints every ``--ckpt-every`` steps, crash-safe resume
(``--resume`` picks the latest commit), and a ``--supervise`` mode that
restarts the run after failures (simulate one with ``--fail-at``).  The
data pipeline is keyed by global step, so a restarted run consumes the
exact batches the crashed run would have.  An encoder-decoder is fed zero
``frames`` and a patch-frontend model zero ``prefix_embeds``, as in the
reference.

Dropped from the reference: ``--tp`` (tensor parallelism over a host mesh)
and the XLA flags it documents (collective fusion, the latency-hiding
scheduler); one device has no mesh.  Added: ``--layers N``, the config cut
to N layers (a stack's depth for an encoder-decoder), for a model whose
full depth the card cannot take.  Checkpoints default to
``<tempdir>/repro_torch_ckpt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.models import build_model
from repro_torch.train import (OptConfig, TrainConfig, init_train_state,
                               make_train_step)


def build(args):
    """(cfg, api, train step) of the arguments."""
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = build_model(cfg, device=args.device)
    tcfg = TrainConfig(opt=OptConfig(lr=args.lr, warmup_steps=args.warmup,
                                     total_steps=args.steps),
                       accum_steps=args.accum)
    return cfg, api, make_train_step(api, tcfg)


def feed(cfg, api, tokens, batch: int, seq: int) -> dict:
    """The step's inputs on the model's device: the tokens, and zero
    ``frames`` or ``prefix_embeds`` for the modality stubs."""
    out = {"tokens": torch.as_tensor(tokens).to(api.device)}
    if cfg.is_encdec:
        out["frames"] = torch.zeros((batch, seq, cfg.d_model),
                                    dtype=cfg.compute_dtype, device=api.device)
    elif cfg.frontend == "patch":
        out["prefix_embeds"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=cfg.compute_dtype,
            device=api.device)
    return out


def run(args) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``).  Returns the first and final loss, every step's loss,
    grad norm and wall seconds (after the step's result reached the host),
    the median of those seconds past the first step, and the final train
    state under ``state``."""
    cfg, api, step_fn = build(args)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    data = SyntheticTokenPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                   seed=args.seed))

    start = 0
    state = init_train_state(api, args.seed)
    if args.resume:
        try:
            state, meta = ckpt.restore_latest(state)
            start = int(meta["step"])
            data.load_state_dict(meta["extra"].get("data", {"step": start}))
            print(f"resumed from step {start}")
        except FileNotFoundError:
            pass

    losses, norms, secs = [], [], []
    for step in range(start, args.steps):
        inputs = feed(cfg, api, data.batch_at(step)["tokens"], args.batch,
                      args.seq)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, inputs)
        loss = float(metrics["loss"])
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        if args.fail_at is not None and step == args.fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {norms[-1]:7.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({secs[-1]:5.2f}s)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, step + 1, extra={"data": data.state_dict(),
                                              "arch": cfg.name})
    if args.ckpt_every:
        ckpt.save(state, args.steps, extra={"data": data.state_dict(),
                                            "arch": cfg.name})
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "losses": losses, "grad_norms": norms, "step_s": secs,
            "step_s_p50": statistics.median(secs[1:]) if len(secs) > 1
            else None, "state": state}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--supervise", action="store_true",
                    help="auto-restart from the latest checkpoint on failure")
    ap.add_argument("--max-restarts", type=int, default=2)
    return ap


def _summary(out: dict) -> dict:
    return {k: out[k] for k in ("final_loss", "first_loss")}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if not args.supervise:
        print(_summary(run(args)))
        return
    restarts = 0
    while True:
        try:
            print(_summary(run(args)))
            return
        except RuntimeError as e:  # node failure — restart from checkpoint
            restarts += 1
            print(f"[supervisor] failure: {e}; restart {restarts}",
                  flush=True)
            if restarts > args.max_restarts:
                raise
            args.resume = True
            args.fail_at = None


if __name__ == "__main__":
    main()
