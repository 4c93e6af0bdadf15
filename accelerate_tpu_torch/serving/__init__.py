"""Continuous-batching serving engine over the paged or the flat KV arena
(``engine.py``, ``pages.py``, ``arena.py``), the replica server that puts
one engine behind HTTP (``replica_server.py``), and the KV-quantization
drift harness (``drift.py``)."""

from .drift import kv_quant_drift
from .engine import Request, ServingEngine, generate_batched
from .pages import NGramDrafter
from .replica_server import ReplicaServer

__all__ = ["NGramDrafter", "ReplicaServer", "Request", "ServingEngine", "generate_batched",
           "kv_quant_drift"]
