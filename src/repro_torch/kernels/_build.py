"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface (device pointers and the
stream as ``void*``, sizes as ``int``; every launcher returns its
``cudaGetLastError()``), compiled for Hopper into
``_build/<name>-<hash>.so`` beside this file.  The hash covers the source,
every ``csrc/*.cuh`` header it includes (and those headers' own), the flags
and any preprocessor defines, so an edited source or header is rebuilt and
an unchanged one is built once per checkout.  A failed build raises with the compiler's output; no
caller falls back to anything else.

Nothing here runs at import time: the CPU-only test machines import every
module of the package and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA "
        "kernels are built from source at first use")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _sources(src: Path) -> list[Path]:
    """``src`` and every header under ``CSRC`` it includes, directly or
    through another, each once, in the order they are first included."""
    seen = [src]
    for path in seen:
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.exists() and header not in seen:
                seen.append(header)
    return seen


def _target(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> str:
    """Compile ``csrc/<name>.cu`` (with ``-D`` each of ``defines``) unless
    an up-to-date library exists.

    Returns the compiler's output (``"cached"`` when nothing was built).
    """
    src, lib = _target(name, defines)
    if lib.exists():
        return "cached"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_flags(defines), "-o", str(tmp),
                           str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}")
    os.replace(tmp, lib)
    return proc.stdout


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    building it if needed."""
    lib = _LOADED.get((name, defines))
    if lib is None:
        build(name, defines)
        lib = ctypes.CDLL(str(_target(name, defines)[1]))
        _LOADED[(name, defines)] = lib
    return lib
