"""Continuous-batching serving engine over the paged or the flat KV arena."""

from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
