"""Decoder model, its configuration, and weight conversion."""

from .configs import DecoderConfig
from .decoder import DecoderLM

__all__ = ["DecoderConfig", "DecoderLM"]
