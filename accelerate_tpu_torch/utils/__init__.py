"""Configuration dataclasses of the port (``utils/dataclasses.py``)."""

from .dataclasses import GradientAccumulationPlugin, MixedPrecisionConfig, PrecisionType

__all__ = ["GradientAccumulationPlugin", "MixedPrecisionConfig", "PrecisionType"]
