"""Serving: the request queue, the batched prefill/decode engine, and the
request-level elastic layer of the co-location day cycle."""
from .elastic import (ElasticConfig, ElasticPool, ReplicaSlots, SLOMonitor,
                      max_offline_share, predicted_tpot_ms, predicted_ttft_ms)
from .engine import (TIER_PERF, BatchQueue, Request, RequestQueue,
                     ServeEngine, relative_scheduled_factor, scheduled_factor)

__all__ = ["TIER_PERF", "BatchQueue", "Request", "RequestQueue",
           "ServeEngine", "relative_scheduled_factor", "scheduled_factor",
           "ElasticConfig", "ElasticPool", "ReplicaSlots", "SLOMonitor",
           "max_offline_share", "predicted_tpot_ms", "predicted_ttft_ms"]
