"""Workload and instance models (paper Table 1 / Table 3)."""
from __future__ import annotations

import dataclasses
import enum


class TopoPolicy(str, enum.Enum):
    GUARANTEED = "guaranteed"
    BEST_EFFORT = "best_effort"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One co-located workload class (≈ a Kubernetes Deployment)."""

    name: str
    priority: int
    gpus_per_instance: int
    cores_per_instance: int
    preemptible: bool
    # Paper Table 1: NUMA affinity (bundle GPU↔local-cores) and socket affinity.
    numa_policy: TopoPolicy = TopoPolicy.GUARANTEED
    socket_policy: TopoPolicy = TopoPolicy.BEST_EFFORT
    critical: bool = True
    kind: str = "online"         # online | offline
    # Optional link to a model architecture served by instances of this workload.
    arch: str | None = None

    def coregroups_per_instance(self, coregroup_size: int) -> int:
        if self.cores_per_instance % coregroup_size:
            raise ValueError(
                f"{self.name}: {self.cores_per_instance} cores not a multiple of "
                f"CoreGroup size {coregroup_size}"
            )
        return self.cores_per_instance // coregroup_size


@dataclasses.dataclass
class Instance:
    """One scheduled instance (≈ a Pod) with its concrete placement."""

    uid: int
    workload: WorkloadSpec
    node: int = -1               # -1 => not scheduled
    gpu_mask: int = 0
    cg_mask: int = 0

    @property
    def name(self) -> str:
        return f"{self.workload.name}-{self.uid}"

    @property
    def priority(self) -> int:
        return self.workload.priority

    @property
    def preemptible(self) -> bool:
        return self.workload.preemptible


# ---- paper presets ------------------------------------------------------------------

def table1_workloads() -> list[WorkloadSpec]:
    """Paper Table 1 (Fig. 3 demonstration): A(32c,4G) B(16c,2G) C(8c,1G)."""
    return [
        WorkloadSpec("A", priority=1000, gpus_per_instance=4, cores_per_instance=32,
                     preemptible=False, kind="online"),
        WorkloadSpec("B", priority=1000, gpus_per_instance=2, cores_per_instance=16,
                     preemptible=False, kind="online"),
        WorkloadSpec("C", priority=100, gpus_per_instance=1, cores_per_instance=8,
                     preemptible=True, numa_policy=TopoPolicy.NONE,
                     socket_policy=TopoPolicy.NONE, critical=False, kind="offline"),
    ]


def table3_workloads() -> list[WorkloadSpec]:
    """Paper Table 3 (KWOK simulation): priorities 1500/1000/500/200."""
    return [
        WorkloadSpec("A", priority=1500, gpus_per_instance=8, cores_per_instance=64,
                     preemptible=False, kind="online"),
        WorkloadSpec("B", priority=1000, gpus_per_instance=4, cores_per_instance=32,
                     preemptible=False, kind="online"),
        WorkloadSpec("C", priority=500, gpus_per_instance=2, cores_per_instance=16,
                     preemptible=True, kind="offline"),
        WorkloadSpec("D", priority=200, gpus_per_instance=1, cores_per_instance=8,
                     preemptible=True, numa_policy=TopoPolicy.NONE,
                     socket_policy=TopoPolicy.NONE, critical=False, kind="offline"),
    ]


# Paper Table 3 initial instance counts for the 100-node saturation allocation.
TABLE3_INITIAL_INSTANCES = {"A": 20, "B": 40, "C": 200, "D": 80}
