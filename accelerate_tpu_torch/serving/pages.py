"""Paged KV arena: fixed-size pages, a refcounted free list, the
copy-on-write prefix cache, and the torch arena helpers.

Counterpart of ``accelerate_tpu/serving/pages.py``. The host-side
classes are this package's own copy of the reference's numpy
bookkeeping (the port imports nothing from the JAX package):

- K/V leaves are ``[num_pages, KVH, page_size, D]`` physical pages per
  layer (a quantized arena: int8 payload pages plus fp32 scale pages
  ``[num_pages, KVH, page_size, 1]``, :func:`init_paged_arena`); a
  per-slot page table ``[num_slots, pages_per_slot] int32``
  maps positions ``[c*page_size, (c+1)*page_size)`` of a slot to a
  physical page. Page 0 is the reserved parking page: unallocated table
  entries point at it, and inactive slots' decode writes land there.
- :class:`PageAllocator` keeps the free list and refcounts.
- :class:`PrefixCache` keys page-aligned prompt prefixes by token hash;
  a hit maps the shared pages into the new slot's table and only the
  tail is prefilled. Shared pages are copy-on-write: the engine forks a
  page (:func:`fork_page`) before the first divergent write.
- :class:`NGramDrafter` proposes speculative drafts from the request's
  own history (prompt lookup).

The torch helpers update the arena and the page tables IN PLACE (JAX
returned new arrays); callers keep using the same tensors.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.quantization import kv_cache_bits


def _digest(tokens: np.ndarray) -> bytes:
    """Stable content key for a token prefix (dtype-normalized so the same
    ids hash equally regardless of the caller's integer width)."""
    return hashlib.blake2b(
        np.ascontiguousarray(tokens, np.int32).tobytes(), digest_size=16
    ).digest()


class PageAllocator:
    """Refcounted free list over ``num_pages`` physical pages.

    Page ids ``< reserved`` are never handed out (page 0 is the parking
    page). A page is free iff its refcount is 0; ``alloc`` pops from the
    free list and sets refcount 1, ``retain`` adds a reference (prefix-cache
    sharing), ``release`` drops one and returns the page to the free list at
    zero. The free list is LIFO so recently-hot pages are reused first.
    """

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(
                f"num_pages ({num_pages}) must exceed reserved ({reserved})"
            )
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self.refs = [0] * num_pages
        self._free = list(range(num_pages - 1, reserved - 1, -1))  # pop() -> lowest id

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - self.reserved - len(self._free)

    def alloc(self) -> Optional[int]:
        """One fresh page with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        page = self._free.pop()
        self.refs[page] = 1
        return page

    def retain(self, page: int):
        if self.refs[page] < 1:
            raise ValueError(f"retain of free page {page}")
        self.refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True when the page returned to the free list."""
        if self.refs[page] < 1:
            raise ValueError(f"release of free page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def shared(self, page: int) -> bool:
        return self.refs[page] > 1


@dataclass
class PrefixEntry:
    key: bytes
    token_len: int
    pages: tuple  # page ids covering [0, token_len)
    hits: int = 0
    last_used: int = 0


class PrefixCache:
    """Prompt-prefix -> shared-pages map, keyed by token-content hash.

    Insertion registers every page-aligned prefix of a finished prompt
    (plus the full, possibly partial-page prompt itself) as an entry; each
    entry holds one allocator reference per covered page. Lookup walks the
    cached lengths longest-first and returns the deepest entry whose token
    hash matches the new prompt. Eviction is LRU at entry granularity; a
    page's storage is reclaimed only when every referencing entry AND
    every mapped slot has released it (the allocator's refcount).
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_entries: int = 512):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.max_entries = int(max_entries)
        self.entries: dict = {}  # key bytes -> PrefixEntry
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt: np.ndarray, limit: Optional[int] = None):
        """Longest cached prefix of ``prompt`` with ``token_len <= limit``.
        Returns ``(hit_len, entry)`` or ``(0, None)``. The caller maps
        ``entry.pages[: ceil(hit_len / page_size)]`` into its slot table
        (retaining each), prefills only ``prompt[hit_len:]``, and reports
        what it actually used via :meth:`record_hit`."""
        self.lookups += 1
        n = int(prompt.size if limit is None else min(prompt.size, limit))
        for length in sorted({e.token_len for e in self.entries.values()},
                             reverse=True):
            if length > n:
                continue
            entry = self.entries.get(_digest(prompt[:length]))
            if entry is not None and entry.token_len == length:
                return length, entry
        return 0, None

    def record_hit(self, tokens: int, entry: Optional[PrefixEntry] = None):
        """Count a lookup hit the caller committed to, with the (possibly
        shrunk) number of prefix tokens served; LRU recency moves here."""
        if tokens > 0:
            self.hits += 1
            self.hit_tokens += int(tokens)
            if entry is not None:
                entry.hits += 1
                entry.last_used = self._tick()

    def insert(self, prompt: np.ndarray, pages) -> int:
        """Register ``prompt`` (whose KV now lives in ``pages``, position
        order) at every page-aligned prefix length plus its full length.
        Each new entry retains its covered pages. Returns the number of
        entries created."""
        ps = self.page_size
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n = int(prompt.size)
        lengths = list(range(ps, n + 1, ps))
        if n % ps:
            lengths.append(n)  # partial-page tail: the COW-fork case
        created = 0
        for length in lengths:
            key = _digest(prompt[:length])
            hit = self.entries.get(key)
            if hit is not None:
                hit.last_used = self._tick()
                continue
            n_pages = -(-length // ps)
            entry = PrefixEntry(
                key=key, token_len=length,
                pages=tuple(int(p) for p in pages[:n_pages]),
                last_used=self._tick(),
            )
            for p in entry.pages:
                self.allocator.retain(p)
            self.entries[key] = entry
            created += 1
        while len(self.entries) > self.max_entries and self.evict_lru():
            pass
        return created

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (releasing its page refs);
        False when the cache is empty."""
        if not self.entries:
            return False
        key = min(self.entries, key=lambda k: self.entries[k].last_used)
        entry = self.entries.pop(key)
        for p in entry.pages:
            self.allocator.release(p)
        return True

    def clear(self):
        """Drop every entry (releasing its page refs)."""
        while self.evict_lru():
            pass

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class NGramDrafter:
    """Prompt-lookup speculative drafter (model-free, host-side).

    ``propose(context, k)`` matches the last ``order`` tokens of the
    request's prompt+generation history against earlier occurrences
    (longest order first, most recent match first) and proposes the ``k``
    tokens that followed; short or missing matches pad by repeating the
    last token. Accepted tokens are always the target model's own
    samples, so a draft only decides how many tokens one verify step
    emits, never which. ``lookback`` bounds the scan to the trailing
    tokens of the history."""

    def __init__(self, order: int = 3, min_order: int = 1, lookback: int = 1024):
        if order < 1 or min_order < 1 or min_order > order:
            raise ValueError(f"bad n-gram orders ({order}, {min_order})")
        if lookback < 2:
            raise ValueError(f"lookback must be >= 2, got {lookback}")
        self.order = int(order)
        self.min_order = int(min_order)
        self.lookback = int(lookback)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        context = np.asarray(context, np.int32).reshape(-1)[-self.lookback:]
        out = np.full((k,), int(context[-1]) if context.size else 0, np.int32)
        if context.size < 2:
            return out
        for n in range(min(self.order, context.size - 1), self.min_order - 1, -1):
            pat = context[-n:]
            # most recent earlier occurrence of the n-gram
            windows = np.lib.stride_tricks.sliding_window_view(context[:-1], n)
            matches = np.nonzero((windows == pat).all(axis=1))[0]
            if matches.size == 0:
                continue
            j = int(matches[-1])
            cont = context[j + n: j + n + k]
            out[: cont.size] = cont
            return out
        return out


class PagedTables:
    """Host mirror of the device page tables: one np row per slot plus the
    allocated-entry count. Entries beyond ``alloc_count`` are parking-page
    padding (gathered but masked, never written by an active slot)."""

    def __init__(self, num_slots: int, pages_per_slot: int, parking: int = 0):
        self.num_slots = int(num_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.parking = int(parking)
        self.rows = np.full((num_slots, pages_per_slot), parking, np.int32)
        self.alloc_count = [0] * num_slots

    def reset_slot(self, slot: int):
        self.rows[slot] = self.parking
        self.alloc_count[slot] = 0

    def slot_pages(self, slot: int) -> list:
        return [int(p) for p in self.rows[slot, : self.alloc_count[slot]]]


# ---------------------------------------------------------------------------
# torch arena helpers (in place)
# ---------------------------------------------------------------------------


def init_paged_arena(config, num_pages: int, page_size: int, device: torch.device,
                     kv_cache_dtype: Optional[str] = None) -> list:
    """All-zeros paged cache: one dict per layer. ``kv_cache_dtype``
    (None: the config's) "bf16" gives ``{"k", "v"}`` leaves
    ``[num_pages, KVH, page_size, D]`` in the config's compute dtype;
    "int8" / "int4" give int8 payload pages ``[num_pages, KVH, page_size,
    D]`` / ``[..., D // 2]`` beside ``{"k_scale", "v_scale"}``
    ``[num_pages, KVH, page_size, 1]`` fp32: the scale pages have the
    payload pages' rank and leading axes, so every page operation moves
    both."""
    bits = kv_cache_bits(kv_cache_dtype or config.kv_cache_dtype)
    rows = (num_pages, config.num_kv_heads, page_size)

    def zeros(width, dtype):
        return torch.zeros(rows + (width,), dtype=dtype, device=device)

    def layer():
        if bits == 16:
            return {"k": zeros(config.head_dim, config.dtype),
                    "v": zeros(config.head_dim, config.dtype)}
        width = config.head_dim // 2 if bits == 4 else config.head_dim
        return {"k": zeros(width, torch.int8), "v": zeros(width, torch.int8),
                "k_scale": zeros(1, torch.float32), "v_scale": zeros(1, torch.float32)}

    return [layer() for _ in range(config.num_layers)]


def fork_page(arena: list, src: int, dst: int):
    """Copy physical page ``src`` -> ``dst`` in every leaf of every layer,
    in place: the copy-on-write fork. A quantized arena's scale pages are
    leaves like the payload pages, so scales ride every fork (and every
    prefix share, which maps the same page ids) with their payload; one
    can never be forked or shared without the other."""
    for layer in arena:
        for leaf in layer.values():
            leaf[dst].copy_(leaf[src])


def set_table_row(tables: torch.Tensor, slot: int, row: np.ndarray):
    """Replace one slot's device page-table row (admission), in place."""
    tables[slot].copy_(torch.as_tensor(row, dtype=tables.dtype))


def set_table_entry(tables: torch.Tensor, slot: int, idx: int, page: int):
    """Point one table entry at a physical page (growth / fork), in place."""
    tables[slot, idx] = int(page)
