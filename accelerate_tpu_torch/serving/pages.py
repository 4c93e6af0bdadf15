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
  page (:func:`fork_page`) before the first divergent write. ``peek``
  probes without touching a gauge (exports, the directory); an
  ``on_evict`` hook demotes a victim's pages into the KV tiers before
  they are released; :class:`GhostCache` shadows the cache at 2x / 4x /
  10x its capacity (the ``serving/ghost_*`` gauges).
- :class:`NGramDrafter` proposes speculative drafts from the request's
  own history (prompt lookup).

The torch helpers update the arena and the page tables IN PLACE (JAX
returned new arrays); callers keep using the same tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.quantization import kv_cache_bits
from .tiers import _digest, wire_dtype


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
    # the entry's own token prefix + owning tenant: what the demote-on-
    # evict hook (serving/tiers.py) needs to rebuild the handoff blob
    # and attribute tier byte-seconds
    tokens: Optional[np.ndarray] = None
    tenant: str = "default"


class _GhostShadow:
    """Key-level LRU twin of a :class:`PrefixCache` at a scaled
    ``max_entries`` — entries are ``key -> [token_len, last_used]``, no
    pages, no allocator. Lookup/insert/evict follow the real cache's
    semantics exactly (longest-first probe, recency on committed hits and
    insert-touch, evict min ``last_used`` past capacity), so its hit count
    equals a brute-force ``PrefixCache(max_entries=N*base)`` replaying the
    same trace."""

    __slots__ = ("max_entries", "entries", "_clock", "hits")

    def __init__(self, max_entries: int):
        self.max_entries = int(max_entries)
        self.entries: dict = {}  # key bytes -> [token_len, last_used]
        self._clock = 0
        self.hits = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, n: int, dig) -> int:
        """Probe like ``PrefixCache.peek`` (longest cached length
        ``<= n`` whose prefix digest matches), self-committing the hit:
        the simulation has no engine to decline it."""
        for length in sorted({e[0] for e in self.entries.values()},
                             reverse=True):
            if length > n:
                continue
            e = self.entries.get(dig(length))
            if e is not None and e[0] == length:
                self.hits += 1
                e[1] = self._tick()
                return length
        return 0

    def insert(self, keyed_lengths):
        for length, key in keyed_lengths:
            e = self.entries.get(key)
            if e is not None:
                e[1] = self._tick()
                continue
            self.entries[key] = [length, self._tick()]
        while len(self.entries) > self.max_entries:
            victim = min(self.entries, key=lambda k: self.entries[k][1])
            del self.entries[victim]


class GhostCache:
    """Ghost-cache economics telemetry for a :class:`PrefixCache`: what
    would larger capacities recover?

    Two instruments, both keys-only (no pages, no KV bytes — the whole
    point is measuring the value of storage that does NOT exist yet):

    - **capacity shadows**: one :class:`_GhostShadow` LRU simulation per
      multiple of the real cache's ``max_entries`` (default 2x/4x/10x),
      fed the same lookup/insert stream. ``hit_ratio(m)`` is the hit
      ratio the cache WOULD have at ``m x`` capacity — compare against
      ``serving/prefix_hit_ratio``; the gap is the reuse an entry-LRU
      host/disk tier (``tiers.py``) would serve.
    - **reuse-after-evict distances**: every key the real cache evicts is
      remembered (bounded, eviction-ordered); when a later ``insert``
      re-registers an evicted key — a re-prefill of KV the cache already
      held, the exact waste a tier absorbs — the distance in lookups
      since eviction is recorded.

    Shadows only model capacity-driven (``max_entries``) eviction: a
    simulated larger cache is assumed to keep its entries' KV in a tier,
    so the real arena's page pressure does not apply to it.
    """

    def __init__(self, base_entries: int, multiples=(2, 4, 10),
                 max_distances: int = 4096):
        self.multiples = tuple(sorted({int(m) for m in multiples}))
        if not self.multiples or self.multiples[0] < 1:
            raise ValueError(f"bad ghost multiples {multiples!r}")
        self.shadows = {
            m: _GhostShadow(m * int(base_entries)) for m in self.multiples
        }
        self.lookups = 0
        self.reuses = 0
        self._evicted: dict = {}  # key -> lookup count at eviction
        self._evicted_cap = max(self.multiples) * int(base_entries)
        self._distances: list = []
        self._max_distances = int(max_distances)

    def observe_lookup(self, prompt: np.ndarray, limit: Optional[int] = None):
        self.lookups += 1
        n = int(prompt.size if limit is None else min(prompt.size, limit))
        memo: dict = {}

        def dig(length):
            d = memo.get(length)
            if d is None:
                d = memo[length] = _digest(prompt[:length])
            return d

        for shadow in self.shadows.values():
            shadow.lookup(n, dig)

    def observe_insert(self, keyed_lengths):
        """``keyed_lengths``: the ``(length, key)`` pairs the real
        insert computed — shared so the prompt hashes exactly once."""
        for _, key in keyed_lengths:
            at = self._evicted.pop(key, None)
            if at is not None:
                self.reuses += 1
                self._distances.append(self.lookups - at)
                if len(self._distances) > self._max_distances:
                    del self._distances[: self._max_distances // 2]
        for shadow in self.shadows.values():
            shadow.insert(keyed_lengths)

    def observe_evict(self, key: bytes):
        self._evicted[key] = self.lookups
        while len(self._evicted) > self._evicted_cap:
            del self._evicted[next(iter(self._evicted))]

    def hit_ratio(self, multiple: int) -> float:
        shadow = self.shadows[int(multiple)]
        return shadow.hits / self.lookups if self.lookups else 0.0

    def reuse_distance_quantile(self, q: float) -> float:
        if not self._distances:
            return 0.0
        xs = sorted(self._distances)
        idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return float(xs[idx])

    def gauges(self) -> dict:
        """``serving/ghost_*`` gauge fragment merged into
        ``ServingEngine.metrics()`` (and so into rollup -> Prometheus
        exposition -> fleet merge; the 2x/4x/10x ratios average across
        replicas, reuse distances take the fleet-worst)."""
        out = {}
        for m in self.multiples:
            out[f"serving/ghost_hit_ratio_{m}x"] = self.hit_ratio(m)
        out["serving/ghost_reuses"] = self.reuses
        if self._distances:
            out["serving/ghost_reuse_distance_p50"] = (
                self.reuse_distance_quantile(0.5)
            )
            out["serving/ghost_reuse_distance_p99"] = (
                self.reuse_distance_quantile(0.99)
            )
        return out


class PrefixCache:
    """Prompt-prefix -> shared-pages map, keyed by token-content hash.

    Insertion registers every page-aligned prefix of a finished prompt
    (plus the full, possibly partial-page prompt itself) as an entry; each
    entry holds one allocator reference per covered page. Lookup walks the
    cached lengths longest-first and returns the deepest entry whose token
    hash matches the new prompt — O(distinct lengths) hash probes, no
    token-by-token trie. Eviction is LRU at entry granularity; a page's
    storage is reclaimed only when every referencing entry AND every
    mapped slot has released it (the allocator's refcount).
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_entries: int = 512, ghost_multiples=(2, 4, 10),
                 ghost_base_entries: Optional[int] = None,
                 on_evict=None):
        self.allocator = allocator
        self.page_size = int(page_size)
        self.max_entries = int(max_entries)
        self.entries: dict = {}  # key bytes -> PrefixEntry
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        # demote-on-evict hook: called with the victim PrefixEntry
        # BEFORE its page refs are released (the pages are still intact
        # on device, so the hook can gather them into a lower tier)
        self.on_evict = on_evict
        # ghost-cache economics telemetry (keys only — a few dict ops per
        # lookup/insert; pass ghost_multiples=None/() to disable).
        # ghost_base_entries overrides the shadows' 1x base: with a
        # host/disk tier attached, the base is the TOTAL (HBM+host+disk)
        # entry capacity so the 2x/4x/10x ratios keep answering "would a
        # bigger cache help?" about capacity beyond what now exists,
        # instead of re-measuring the tier just built.
        self.ghost = (
            GhostCache(
                int(ghost_base_entries) if ghost_base_entries
                else self.max_entries,
                ghost_multiples,
            )
            if ghost_multiples else None
        )

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _candidate_lengths(self) -> list:
        return sorted({e.token_len for e in self.entries.values()}, reverse=True)

    def lookup(self, prompt: np.ndarray, limit: Optional[int] = None):
        """Longest cached prefix of ``prompt`` with ``token_len <= limit``.
        Returns ``(hit_len, entry)`` or ``(0, None)``. The caller maps
        ``entry.pages[: ceil(hit_len / page_size)]`` into its slot table
        (retaining each) and prefills only ``prompt[hit_len:]`` — then
        reports what it actually used via :meth:`record_hit` (the engine
        may shrink or discard a hit whose tail plan would not fit the slot
        or would cost more prefill dispatches than a cold admission, and
        the hit-ratio gauges must reflect the final decision)."""
        self.lookups += 1
        if self.ghost is not None:
            self.ghost.observe_lookup(prompt, limit)
        return self.peek(prompt, limit)

    def peek(self, prompt: np.ndarray, limit: Optional[int] = None):
        """:meth:`lookup` without side effects: the hit/lookup gauges and
        LRU recency stay untouched. The KV-handoff export path (a replica
        shipping cached pages to a peer) and router introspection probe
        with this — a probe is not serving traffic and must not skew the
        hit-ratio gauges or LRU-protect an entry it never admitted."""
        n = int(prompt.size if limit is None else min(prompt.size, limit))
        for length in self._candidate_lengths():
            if length > n:
                continue
            entry = self.entries.get(_digest(prompt[:length]))
            if entry is not None and entry.token_len == length:
                return length, entry
        return 0, None

    def record_hit(self, tokens: int, entry: Optional[PrefixEntry] = None):
        """Count a lookup hit that the caller actually committed to, with
        the (possibly shrunk) number of prefix tokens served. LRU recency
        moves here too: an entry whose hits are always declined must not
        stay LRU-protected, pinning its pages over genuinely useful ones."""
        if tokens > 0:
            self.hits += 1
            self.hit_tokens += int(tokens)
            if entry is not None:
                entry.hits += 1
                entry.last_used = self._tick()

    def insert(self, prompt: np.ndarray, pages, tenant: str = "default") -> int:
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
        keyed = [(length, _digest(prompt[:length])) for length in lengths]
        created = 0
        for length, key in keyed:
            hit = self.entries.get(key)
            if hit is not None:
                hit.last_used = self._tick()
                continue
            n_pages = -(-length // ps)
            entry = PrefixEntry(
                key=key, token_len=length, pages=tuple(int(p) for p in pages[:n_pages]),
                last_used=self._tick(),
                tokens=prompt[:length].copy(), tenant=str(tenant or "default"),
            )
            for p in entry.pages:
                self.allocator.retain(p)
            self.entries[key] = entry
            created += 1
        if self.ghost is not None:
            self.ghost.observe_insert(keyed)
        while len(self.entries) > self.max_entries and self.evict_lru():
            pass
        return created

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (releasing its page refs);
        False when the cache is empty. Called by the engine when the
        allocator cannot satisfy an admission or a decode-time page grow.
        With a demote hook attached, the victim's KV is offered to the
        lower tiers first — eviction demotes instead of dropping."""
        if not self.entries:
            return False
        self.evict(min(self.entries, key=lambda k: self.entries[k].last_used))
        return True

    def evict(self, key: bytes):
        """Drop the entry under ``key`` as :meth:`evict_lru` drops its
        victim: demoted through the hook, its page refs released."""
        entry = self.entries.pop(key)
        if self.on_evict is not None:
            # pages are still retained here: the hook may gather them
            try:
                self.on_evict(entry)
            except Exception:
                # demotion is an optimization; a failing tier must never
                # turn an eviction into an engine error
                pass
        for p in entry.pages:
            self.allocator.release(p)
        if self.ghost is not None:
            self.ghost.observe_evict(key)

    def clear(self):
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


# ---------------------------------------------------------------------------
# the KV handoff's wire leaves (export, import, tier demote and restore)
# ---------------------------------------------------------------------------

# The reference's arena is one scan-stacked tree whose K/V leaves, in its
# flatten order, name the wire's leaves; each is [L, n_pages, KVH,
# page_size, width] with the page axis at 1. The port's arena is a list of
# per-layer dicts with the page axis at 0: a wire leaf is the layers'
# pages stacked.
_WIRE_PREFIX = "['layers']['block']['attn']"
WIRE_LEAVES = (("k", "cached_key"), ("k_scale", "cached_key_scale"),
               ("v", "cached_value"), ("v_scale", "cached_value_scale"))


def wire_dtype_name(dtype: torch.dtype) -> str:
    """The wire's (numpy's) name of a torch dtype: "bfloat16", "float32",
    "int8"."""
    return str(dtype).replace("torch.", "")


def wire_leaf_specs(arena: list) -> list:
    """``(path, leaf name, shape of one page, wire dtype name)`` per wire
    leaf, in the reference's flatten order; ``shape`` is ``[L, KVH,
    page_size, width]``, the wire leaf's without its page axis."""
    specs = []
    for name, ref in WIRE_LEAVES:
        leaf = arena[0].get(name)
        if leaf is None:
            continue
        specs.append((f"{_WIRE_PREFIX}['{ref}']", name,
                      [len(arena), *leaf.shape[1:]], wire_dtype_name(leaf.dtype)))
    return specs


def gather_pages(arena: list, page_ids) -> list:
    """Host copies of physical pages ``page_ids`` as the wire's leaves
    (numpy, ``[L, n, KVH, page_size, width]``, bf16 as raw ``uint16``
    words), in :func:`wire_leaf_specs` order: the export and demote read.
    One ``index_select`` per layer leaf into one device byte buffer, then
    one copy to the host."""
    specs = wire_leaf_specs(arena)
    dev = arena[0][specs[0][1]].device
    ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=dev)
    stacked = [torch.stack([layer[name].index_select(0, ids) for layer in arena])
               for _, name, _, _ in specs]
    host = torch.cat([t.view(torch.uint8).reshape(-1) for t in stacked]).cpu().numpy()
    out, at = [], 0
    for t, (_, _, _, dname) in zip(stacked, specs):
        n = t.numel() * t.element_size()
        out.append(host[at:at + n].view(wire_dtype(dname)).reshape(tuple(t.shape)))
        at += n
    return out


def install_pages(arena: list, arrays: list, pages) -> None:
    """Write wire leaves ``arrays`` (``[L, n, ...]`` host arrays in
    :func:`wire_leaf_specs` order, bf16 as ``uint16`` words) into physical
    pages ``pages``, IN PLACE: the import and restore write. The arena's
    tensors keep their addresses, which the captured decode and verify
    graphs read; the copies run on the caller's current stream, ahead of
    the next replay."""
    specs = wire_leaf_specs(arena)
    dev = arena[0][specs[0][1]].device
    ids = torch.as_tensor(list(pages), dtype=torch.long, device=dev)
    for (_, name, _, _), arr in zip(specs, arrays):
        dtype = arena[0][name].dtype
        # a wire leaf decoded from base64 is read-only: torch wants a
        # writable buffer even to read from
        src = torch.from_numpy(np.require(arr, requirements=("C", "W"))).view(dtype).to(dev)
        for layer, rows in zip(arena, src):
            layer[name].index_copy_(0, ids, rows)
