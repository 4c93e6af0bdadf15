"""The flat slot arena of the serving engine.

Counterpart of ``accelerate_tpu/serving/arena.py``. The arena is the
model's dense KV cache made at batch ``num_slots`` (:meth:`DecoderLM.
init_cache`): per layer ``{"k", "v"}`` [num_slots, KVH, max_cache_len, D]
(int8 payloads plus ``{"k_scale", "v_scale"}`` when quantized) and the
``"index"`` the single-stream path reads. Each batch row is one slot, an
independent request at its own depth. Admission writes a slot's prefix
through :func:`slot_view`; decode scatters one token per slot; a freed
slot is reused without clearing, because every position is written
before it can be attended.
"""

from __future__ import annotations

import torch


def _is_kv(leaf) -> bool:
    return isinstance(leaf, torch.Tensor)


def init_arena(model, num_slots: int, max_cache_len: int, kv_cache_dtype=None) -> list:
    """All-zeros arena for ``num_slots`` concurrent requests of up to
    ``max_cache_len`` positions (``kv_cache_dtype`` None: the model
    config's)."""
    return model.init_cache(num_slots, max_cache_len, kv_cache_dtype)


def arena_num_slots(arena: list) -> int:
    for layer in arena:
        for leaf in layer.values():
            if _is_kv(leaf):
                return int(leaf.shape[0])
    raise ValueError("arena holds no K/V leaves")


def arena_nbytes(arena: list) -> int:
    return sum(t.numel() * t.element_size() for layer in arena
               for t in layer.values() if _is_kv(t))


def slot_view(arena: list, slot: int, start: int) -> list:
    """Batch-1 cache for one slot whose single-stream index is ``start``,
    so a prefill chunk continues the slot where its previous chunk
    stopped. The K/V leaves are views along the slot axis: writes through
    them land in the arena in place."""
    return [{name: leaf[slot:slot + 1] if _is_kv(leaf) else int(start)
             for name, leaf in layer.items()} for layer in arena]


def write_slot(arena: list, slot_tree: list, slot: int) -> list:
    """Write a batch-1 slot cache's K/V back into the arena (a no-op for
    the views :func:`slot_view` returns). The arena's index leaves keep
    their value: per-slot progress lives in the engine."""
    for layer, view in zip(arena, slot_tree):
        for name, leaf in layer.items():
            if _is_kv(leaf) and view[name].data_ptr() != leaf[slot:slot + 1].data_ptr():
                leaf[slot:slot + 1].copy_(view[name])
    return arena
