"""PyTorch/CUDA port of ``accelerate_tpu``'s paged serving path.

The JAX package (``accelerate_tpu``) stays the reference; this package is
its counterpart for an NVIDIA H100. Module paths mirror the reference:

- ``models/configs.py``, ``models/decoder.py``, ``models/convert.py``
- ``ops/layers.py``, ``ops/attention.py`` (plain versions + kernel
  dispatch), ``ops/kernels.py`` (nvcc build, ctypes binding, checked
  wrappers with launch counters), ``csrc/*.cu`` (the hand-written
  Hopper kernels)
- ``serving/pages.py``, ``serving/engine.py``, ``generation.py``

Entry points take ``device=None``, which means CUDA; without CUDA they
raise unless the caller passes ``device="cpu"`` (the plain PyTorch
versions of the kernels then run). Nothing here imports JAX.
"""

from .models.configs import DecoderConfig
from .models.decoder import DecoderLM
from .serving.engine import ServingEngine

__all__ = ["DecoderConfig", "DecoderLM", "ServingEngine"]
