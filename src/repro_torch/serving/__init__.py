"""Serving substrate: engine, KV cache management, Demeter autoscaling."""
from .autoscale import (ClusterModelParams, ReplicaProfile, ServingCluster,
                        ServingExecutor, calibrate)
from .engine import EngineMetrics, Request, ServingEngine
from .kv_cache import KVCacheManager, SlotState

__all__ = ["ServingEngine", "Request", "EngineMetrics", "KVCacheManager",
           "SlotState", "ServingCluster", "ServingExecutor", "calibrate",
           "ReplicaProfile", "ClusterModelParams"]
