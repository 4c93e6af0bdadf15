"""Configuration dataclasses of the port (``utils/dataclasses.py``) and
``set_seed`` (``utils/random.py``)."""

from .dataclasses import (AutocastKwargs, GradientAccumulationPlugin, GradScalerKwargs,
                          MixedPrecisionConfig, PrecisionType, ProjectConfiguration)
from .random import set_seed

__all__ = ["AutocastKwargs", "GradScalerKwargs", "GradientAccumulationPlugin",
           "MixedPrecisionConfig", "PrecisionType", "ProjectConfiguration", "set_seed"]
