"""Public entry points for the CUDA kernels.

``topo_score`` is the counterpart of ``repro.kernels.ops.topo_score``: the
dense tier and Eq. 1 score per victim subset.  ``flash_attention`` is the
counterpart of ``repro.kernels.ops.flash_attention``: blocked causal /
sliding-window GQA attention.  Each runs its hand-written kernel for CUDA
tensors and the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import topo_score as _ts


def topo_score(combo_gpu, combo_cg, prio, spec, req):
    return _ts.topo_score(combo_gpu, combo_cg, prio, spec, req)


def flash_attention(q, k, v, *, causal=True, window=None):
    return _fa.flash_attention(q, k, v, causal=causal, window=window)
