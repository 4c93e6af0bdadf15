"""Continuous-batching serving engine over the paged or the flat KV arena
(``engine.py``, ``pages.py``, ``arena.py``), its multi-tenant scheduling
policy (``scheduler.py``) and fault injection (``faults.py``), the replica
server that puts one engine behind HTTP (``replica_server.py``), and the
KV-quantization drift harness (``drift.py``)."""

from .drift import kv_quant_drift
from .engine import Request, ServingEngine, generate_batched
from .faults import FaultInjector
from .pages import NGramDrafter
from .replica_server import ReplicaServer
from .scheduler import MultiTenantScheduler, SchedulerConfig, TenantConfig

__all__ = ["FaultInjector", "MultiTenantScheduler", "NGramDrafter", "ReplicaServer", "Request",
           "SchedulerConfig", "ServingEngine", "TenantConfig", "generate_batched",
           "kv_quant_drift"]
