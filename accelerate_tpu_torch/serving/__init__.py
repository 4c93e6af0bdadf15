"""Paged continuous-batching serving engine."""

from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
