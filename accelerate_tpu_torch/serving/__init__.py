"""Continuous-batching serving engine over the paged or the flat KV arena
(``engine.py``, ``pages.py``, ``arena.py``), its multi-tenant scheduling
policy (``scheduler.py``) and fault injection (``faults.py``), the replica
server that puts one engine behind HTTP (``replica_server.py``), the KV
tiers under the prefix cache (``tiers.py``), the router in front of the
replicas (``router.py``) and the KV-quantization drift harness
(``drift.py``)."""

# resolved at first use (PEP 562): the router and the KV tiers import
# without torch, so this package's import must not pull in the engine
_EXPORTS = {
    "kv_quant_drift": "drift", "Request": "engine", "ServingEngine": "engine",
    "generate_batched": "engine", "FaultInjector": "faults", "NGramDrafter": "pages",
    "ReplicaServer": "replica_server", "MultiTenantScheduler": "scheduler",
    "SchedulerConfig": "scheduler", "TenantConfig": "scheduler",
    "Router": "router", "RouterConfig": "router", "RouterServer": "router",
    "TierConfig": "tiers", "TieredStore": "tiers",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


__all__ = sorted(_EXPORTS)
