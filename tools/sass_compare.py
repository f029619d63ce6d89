#!/usr/bin/env python3
"""Compare the SASS of every kernel in two checkouts' CUDA sources.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/sass_compare.py OTHER_SRC [SOURCE ...]

OTHER_SRC is the ``src`` directory of another checkout (an unpacked
archive of a parent commit); each SOURCE (default ``flash_attention`` and
``flash_attention_bwd``) is a ``csrc/<SOURCE>.cu`` of both trees, built
with the package's nvcc flags beside its own headers.  ``cuobjdump
-sass`` of each build is cut into functions; a function's name is taken
without the anonymous namespace's per-file hash, and its body without
the ``Function :`` line.  One JSON line a source: the functions whose
bodies are identical, those that differ, and those found in one build
only.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def functions(lib: Path) -> dict[str, str]:
    """Each function's SASS body in ``lib``, keyed by its name with the
    anonymous namespace's hash removed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "ANON",
                         m.group(1))
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line.strip())
    return {k: "\n".join(v) for k, v in funcs.items()}


def build(csrc: Path, name: str, out: Path) -> Path:
    from repro_torch.kernels import _build

    lib = out / f"{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    return lib


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve() / "repro_torch" / "kernels" / "csrc"
    mine = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for name in argv[1:] or ["flash_attention", "flash_attention_bwd"]:
        with tempfile.TemporaryDirectory() as tmp:
            a, b = Path(tmp, "other"), Path(tmp, "mine")
            a.mkdir()
            b.mkdir()
            fa = functions(build(other, name, a))
            fb = functions(build(mine, name, b))
        both = sorted(set(fa) & set(fb))
        print(json.dumps({
            "source": f"{name}.cu",
            "identical": [f for f in both if fa[f] == fb[f]],
            "different": [f for f in both if fa[f] != fb[f]],
            "only_other": sorted(set(fa) - set(fb)),
            "only_mine": sorted(set(fb) - set(fa))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
