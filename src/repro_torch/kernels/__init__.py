"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

topo_score — the paper's candidate-sourcing hot loop as bitmask lane math
(``csrc/topo_score.cu``), and the ``imp_pallas`` engine that launches it.
"""
from . import ops, topo_score

__all__ = ["ops", "topo_score"]
