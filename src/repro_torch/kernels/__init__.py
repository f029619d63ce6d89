"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

topo_score — the paper's candidate-sourcing hot loop as bitmask lane math
(``csrc/topo_score.cu``), and the ``imp_pallas`` engine that launches it.
flash_attention — blocked causal / sliding-window GQA attention, the
serving path's prefill attention (``csrc/flash_attention.cu``).
"""
from . import flash_attention, ops, topo_score

#: every kernel wrapper of the package (their ``launches`` counters)
WRAPPERS = topo_score.WRAPPERS + (flash_attention.flash_attention,)

__all__ = ["WRAPPERS", "flash_attention", "ops", "topo_score"]
