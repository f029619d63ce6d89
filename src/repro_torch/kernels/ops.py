"""Public entry points for the CUDA kernels.

``topo_score`` is the counterpart of ``repro.kernels.ops.topo_score``: the
dense tier and Eq. 1 score per victim subset.  It runs the hand-written
kernel for CUDA tensors and the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

from . import topo_score as _ts


def topo_score(combo_gpu, combo_cg, prio, spec, req):
    return _ts.topo_score(combo_gpu, combo_cg, prio, spec, req)
