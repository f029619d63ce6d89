"""Core: the paper's contribution — FlexTopo + topology-aware preemption.

Exports what this package has ported so far: the host layer (topology,
workloads, placement, scoring, FlexTopo, cluster state), the device-resident
cluster state, the transactional scheduler with the host engines, and the
Table 4/5 simulator protocols.  The ``imp_pallas`` engine registers lazily
from `repro_torch.kernels`, the fused ``imp_batched`` engine from
`repro_torch.core.preemption_device`.
"""
from .cluster import (MAX_DENSE_VICTIMS, Cluster, ClusterArrays, ClusterView,
                      DeviceClusterState, SourcingContext, instance_rows)
from .decisions import SchedulingDecision, Transaction, TransactionError
from .engines import (EngineName, SourcingEngine, UnknownEngineError,
                      get_engine, register_engine, registered_engines)
from .flextopo import FlexTopo, FlexTopoMasks
from .placement import (INFEASIBLE, Placement, achieved_tier, best_tier,
                        is_topology_hit, min_tier_for, place, place_blind)
from .scheduler import AUTO_ENGINE_THRESHOLD, ShortlistConfig, TopoScheduler
from .scoring import Candidate, score, select_best
from .simulator import (HitRateReport, SimConfig, build_saturated_cluster,
                        run_hit_rate_experiment, run_latency_experiment,
                        run_plan_latency_experiment)
from .topology import A100_SERVER, RTX4090_SERVER, SPECS, TPU_V5E_HOST, ServerSpec
from .workload import (TABLE3_INITIAL_INSTANCES, Instance, TopoPolicy,
                       WorkloadSpec, table1_workloads, table3_workloads)

__all__ = [
    "Cluster", "ClusterArrays", "ClusterView", "DeviceClusterState",
    "SourcingContext", "MAX_DENSE_VICTIMS",
    "instance_rows", "SchedulingDecision", "Transaction", "TransactionError",
    "EngineName", "SourcingEngine", "UnknownEngineError", "get_engine",
    "register_engine", "registered_engines", "FlexTopo", "FlexTopoMasks",
    "INFEASIBLE", "Placement", "achieved_tier", "best_tier",
    "is_topology_hit", "min_tier_for", "place", "place_blind",
    "AUTO_ENGINE_THRESHOLD", "ShortlistConfig", "TopoScheduler",
    "Candidate", "score", "select_best", "HitRateReport", "SimConfig",
    "build_saturated_cluster", "run_hit_rate_experiment",
    "run_latency_experiment", "run_plan_latency_experiment",
    "A100_SERVER", "RTX4090_SERVER", "SPECS", "TPU_V5E_HOST", "ServerSpec",
    "TABLE3_INITIAL_INSTANCES", "Instance", "TopoPolicy", "WorkloadSpec",
    "table1_workloads", "table3_workloads",
]
