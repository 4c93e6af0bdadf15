"""Continuous-batching serving engine over the paged or the flat KV arena,
and the KV-quantization drift harness."""

from .drift import kv_quant_drift
from .engine import Request, ServingEngine
from .pages import NGramDrafter

__all__ = ["NGramDrafter", "Request", "ServingEngine", "kv_quant_drift"]
