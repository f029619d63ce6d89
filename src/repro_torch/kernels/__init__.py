"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

topo_score — the paper's candidate-sourcing hot loop as bitmask lane math
(``csrc/topo_score.cu``), and the ``imp_pallas`` engine that launches it.
fused_class, normal_cycle — the fused ``imp_batched`` engine's kernels over
the device-resident cluster state, in the same source: K1's resident form
(the class sweep of every row of a plan in one launch) and its tail, and
K2's normal-cycle form.
view_delta, prescreen — the rest of that engine's default path, in the same
source: the view-delta encoder (a plan's patch rows rebuilt on the device)
and the shortlist's prescreen (a bound per row and the top K).
Over a sharded state (``imp_sharded``) the last shard's tail and normal
cycle merge the earlier shards' records in their own launches
(``fused_argmax(prior=)``, ``normal_cycle(prior=)``; their plain versions
``fused_class.tail_merge_plain`` and ``normal_cycle.normal_merge_plain``),
and ``prescreen.prescreen_select`` merges the shards' shortlists.
flash_attention — blocked causal / sliding-window GQA attention, the
serving path's prefill attention (``csrc/flash_attention.cu``).
recurrent — the recurrent families' time-step scans: RWKV-6's WKV and the
RG-LRU's gated diagonal recurrence (``csrc/recurrent.cu``).
"""
from . import (flash_attention, fused_class, normal_cycle, ops, prescreen,
               recurrent, topo_score, view_delta)

#: every kernel wrapper of the package (their ``launches`` counters)
WRAPPERS = (topo_score.WRAPPERS + fused_class.WRAPPERS + normal_cycle.WRAPPERS
            + view_delta.WRAPPERS + prescreen.WRAPPERS
            + (flash_attention.flash_attention,) + recurrent.WRAPPERS)

__all__ = ["WRAPPERS", "flash_attention", "fused_class", "normal_cycle", "ops",
           "prescreen", "recurrent", "topo_score", "view_delta"]
