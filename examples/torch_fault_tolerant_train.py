"""Fault-tolerant training on the PyTorch/CUDA port: checkpoint -> injected
failure -> supervised restart resumes the exact data stream.

The same run as ``examples/fault_tolerant_train.py``, through
``python -m repro_torch.launch.train`` (the smoke llama3.2-1b, 16 steps of
4 x 64 tokens, a checkpoint every 5 steps, a failure injected at step 8,
``--supervise``), on the card unless ``--device cpu``.

    python examples/torch_fault_tolerant_train.py [--device cuda|cpu]
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).parent.parent


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt:
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", "llama3.2-1b", "--steps", "16", "--batch", "4",
               "--seq", "64", "--ckpt-every", "5", "--log-every", "4",
               "--ckpt-dir", ckpt, "--supervise", "--fail-at", "8",
               "--device", args.device]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        print("running with an injected failure at step 8 + supervisor...")
        out = subprocess.run(cmd, capture_output=True, text=True, env=env)
        print(out.stdout)
        assert out.returncode == 0, out.stderr
        assert "injected failure" in out.stdout, "no failure was injected!"
        assert "resumed from step" in out.stdout, "supervisor did not resume!"
        print("supervisor resumed from checkpoint and finished: OK")
    return out.stdout


if __name__ == "__main__":
    main()
