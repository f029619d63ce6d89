"""Server hardware topology specs (paper §2.2, Fig. 2).

A ServerSpec statically describes one GPU-server SKU: sockets, NUMA nodes,
CPU cores (grouped into configurable CoreGroups, paper Table 2), GPU devices,
and the communication-cost matrix between NUMA tiers (paper Fig. 2).

Everything downstream (FlexTopo graphs, bitmask arrays, the CUDA scoring
kernels) derives its static masks from this spec.  Bitmask convention: GPU g is
bit g of an int32; CoreGroup c is bit c of a separate int32.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = [
    "ServerSpec",
    "RTX4090_SERVER",
    "A100_SERVER",
    "TPU_V5E_HOST",
    "SPECS",
]


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """Static hardware topology of one server SKU."""

    name: str
    num_sockets: int
    num_numa: int          # total NUMA nodes (must be divisible by sockets)
    num_cores: int         # total CPU cores
    num_gpus: int          # total accelerator devices
    coregroup_size: int    # cores per CoreGroup (paper: configurable, default 8)
    # Fig. 2 communication-cost matrix (relative units)
    intra_numa_cost: int = 10
    cross_numa_cost: int = 12    # different NUMA, same socket
    cross_socket_cost: int = 32
    gpu_model: str = "NVIDIA RTX 4090"
    gpu_memory_mb: int = 24_000

    def __post_init__(self) -> None:
        if self.num_numa % self.num_sockets:
            raise ValueError("NUMA nodes must divide evenly across sockets")
        if self.num_cores % self.coregroup_size:
            raise ValueError("cores must divide evenly into CoreGroups")
        n_cg = self.num_cores // self.coregroup_size
        if n_cg % self.num_numa:
            raise ValueError("CoreGroups must divide evenly across NUMA nodes")
        if self.num_gpus % self.num_numa and self.num_numa % self.num_gpus:
            raise ValueError("GPUs and NUMA nodes must nest evenly")
        if self.num_gpus > 32 or n_cg > 32:
            raise ValueError("bitmask encoding supports at most 32 GPUs/CoreGroups")

    # ---- derived cardinalities -------------------------------------------------
    @property
    def num_coregroups(self) -> int:
        return self.num_cores // self.coregroup_size

    @property
    def numa_per_socket(self) -> int:
        return self.num_numa // self.num_sockets

    @property
    def gpus_per_numa(self) -> int:
        return max(1, self.num_gpus // self.num_numa)

    @property
    def coregroups_per_numa(self) -> int:
        return self.num_coregroups // self.num_numa

    # ---- locality maps ----------------------------------------------------------
    def socket_of_numa(self, numa: int) -> int:
        return numa // self.numa_per_socket

    def numa_of_gpu(self, gpu: int) -> int:
        if self.num_gpus >= self.num_numa:
            return gpu // (self.num_gpus // self.num_numa)
        # fewer GPUs than NUMA nodes: spread one GPU per leading NUMA
        return gpu * (self.num_numa // self.num_gpus)

    def numa_of_coregroup(self, cg: int) -> int:
        return cg // self.coregroups_per_numa

    def numa_of_core(self, core: int) -> int:
        return self.numa_of_coregroup(core // self.coregroup_size)

    def cores_of_coregroup(self, cg: int) -> range:
        return range(cg * self.coregroup_size, (cg + 1) * self.coregroup_size)

    def socket_of_gpu(self, gpu: int) -> int:
        return self.socket_of_numa(self.numa_of_gpu(gpu))

    # ---- Fig. 2 cost matrix -----------------------------------------------------
    def comm_cost(self, numa_a: int, numa_b: int) -> int:
        """Relative communication cost between two NUMA nodes (paper Fig. 2)."""
        if numa_a == numa_b:
            return self.intra_numa_cost
        if self.socket_of_numa(numa_a) == self.socket_of_numa(numa_b):
            return self.cross_numa_cost
        return self.cross_socket_cost

    # ---- static bitmasks (engine inputs) ----------------------------------------
    @cached_property
    def numa_gpu_masks(self) -> np.ndarray:
        """int32[num_numa] — bit g set iff GPU g is `nearby` NUMA u."""
        masks = np.zeros(self.num_numa, dtype=np.int32)
        for g in range(self.num_gpus):
            masks[self.numa_of_gpu(g)] |= 1 << g
        return masks

    @cached_property
    def numa_cg_masks(self) -> np.ndarray:
        """int32[num_numa] — bit c set iff CoreGroup c is `localized` to NUMA u."""
        masks = np.zeros(self.num_numa, dtype=np.int32)
        for c in range(self.num_coregroups):
            masks[self.numa_of_coregroup(c)] |= 1 << c
        return masks

    @cached_property
    def socket_gpu_masks(self) -> np.ndarray:
        masks = np.zeros(self.num_sockets, dtype=np.int32)
        for g in range(self.num_gpus):
            masks[self.socket_of_gpu(g)] |= 1 << g
        return masks

    @cached_property
    def socket_cg_masks(self) -> np.ndarray:
        masks = np.zeros(self.num_sockets, dtype=np.int32)
        for c in range(self.num_coregroups):
            masks[self.socket_of_numa(self.numa_of_coregroup(c))] |= 1 << c
        return masks

    @cached_property
    def socket_of_numa_arr(self) -> np.ndarray:
        return np.array(
            [self.socket_of_numa(u) for u in range(self.num_numa)], dtype=np.int32
        )

    @property
    def all_gpu_mask(self) -> int:
        return (1 << self.num_gpus) - 1

    @property
    def all_cg_mask(self) -> int:
        return (1 << self.num_coregroups) - 1


# Paper Fig. 2 SKUs ----------------------------------------------------------------
# 4090 server: 2 sockets, 8 NUMA, 64 cores, 8 GPUs; costs 10 / 12 / 32.
RTX4090_SERVER = ServerSpec(
    name="rtx4090",
    num_sockets=2,
    num_numa=8,
    num_cores=64,
    num_gpus=8,
    coregroup_size=8,
    intra_numa_cost=10,
    cross_numa_cost=12,
    cross_socket_cost=32,
    gpu_model="NVIDIA RTX 4090",
    gpu_memory_mb=24_000,
)

# A100 server: 2 sockets, 2 NUMA, 128 cores, 8 GPUs; costs 10 / 20 (one NUMA per
# socket, so cross-NUMA == cross-socket == 20).
A100_SERVER = ServerSpec(
    name="a100",
    num_sockets=2,
    num_numa=2,
    num_cores=128,
    num_gpus=8,
    coregroup_size=8,
    intra_numa_cost=10,
    cross_numa_cost=20,
    cross_socket_cost=20,
    gpu_model="NVIDIA A100-SXM",
    gpu_memory_mb=80_000,
)

# TPU adaptation (DESIGN.md §3): one v5e host = 1 "socket" CPU domain with 4
# chips; NUMA tiers map to {same chip, same host} and cross_socket models the
# ICI hop to a neighbouring host in the same torus slice.
TPU_V5E_HOST = ServerSpec(
    name="tpu_v5e_host",
    num_sockets=2,
    num_numa=4,
    num_cores=112,
    num_gpus=4,
    coregroup_size=28,
    intra_numa_cost=10,
    cross_numa_cost=13,
    cross_socket_cost=25,
    gpu_model="TPU v5e",
    gpu_memory_mb=16_000,
)

SPECS = {s.name: s for s in (RTX4090_SERVER, A100_SERVER, TPU_V5E_HOST)}
