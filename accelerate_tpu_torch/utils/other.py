"""``save``: counterpart of ``accelerate_tpu/utils/other.py``'s."""

from __future__ import annotations

from .serialization import save_pytree


def save(obj, path, save_on_each_node: bool = False, safe_serialization: bool = True):
    """Write a tree of tensors (or numpy arrays) to ``path``: safetensors,
    or a pickle of numpy arrays with ``safe_serialization=False``. The
    port runs one process, which is the main one, so ``save_on_each_node``
    changes nothing."""
    return save_pytree(obj, path, safe_serialization=safe_serialization)
