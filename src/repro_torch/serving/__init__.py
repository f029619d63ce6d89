"""Serving: the request queue and the batched prefill/decode engine."""
from .engine import (TIER_PERF, BatchQueue, Request, RequestQueue,
                     ServeEngine, relative_scheduled_factor, scheduled_factor)

__all__ = ["TIER_PERF", "BatchQueue", "Request", "RequestQueue",
           "ServeEngine", "relative_scheduled_factor", "scheduled_factor"]
