"""Hierarchical KV tiering: demote-on-evict prefix store under the HBM
prefix cache — host RAM → disk blobs → fleet peers.

An own copy of the reference's ``accelerate_tpu/serving/tiers.py``.
Instead of dropping an evicted :class:`~.pages.PrefixEntry`'s pages, the
engine demotes the entry's KV down a tier and a later admission restores
it: prefill compute (the TTFT budget) traded for cheap PCIe / disk /
network bytes.

The storage format at every tier is the **KV handoff blob**
(``ServingEngine.export_prefix_kv``), the reference's wire format: one
entry per reference arena leaf (the scan-stacked
``['layers']['block']['attn']['cached_key']`` and friends), each
``[L, n_pages, KVH, page_size, D]``, payload AND scale leaves alike, so
quantized pages ride every tier untouched. The disk tier is a
handoff-to-yourself (the wire dict serialized to JSON, plus a checksum
so a torn write is rejected, never installed); the peer tier rides the
``/v1/kv/export`` wire: replicas advertise a digest directory
(``/v1/kv/directory``) and a miss pulls a warm prefix from a peer
instead of recomputing it. Blobs and handoffs cross between the
reference's replicas and the port's in both directions.

bfloat16 has no numpy dtype without ``ml_dtypes``, which the port does
not use: a bf16 leaf is held as its raw 2-byte words (a ``uint16``
array) and named ``"bfloat16"`` on the wire (:func:`wire_dtype`), never
widened and narrowed back.

Tier probe order is **longest-prefix-first across all tiers**: for each
page-aligned candidate length, descending, the store checks host, then
disk, then the peer directories — the first hit wins, so a shorter hit
in a fast tier never shadows a longer one in a slow tier.

Everything here is host-side bookkeeping over numpy arrays and JSON, no
torch (a CPU test imports it with torch blocked). The device work (the
page gather on demote, the in-place page installs on restore) stays in
the engine.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

# tier names, probe order (hbm is the PrefixCache itself; this module
# owns the three below it)
TIERS = ("hbm", "host", "disk", "peer")

BLOB_SUFFIX = ".kvblob.json"


def _digest(tokens: np.ndarray) -> bytes:
    """Stable content key for a token prefix (dtype-normalized so the same
    ids hash equally regardless of the caller's integer width): the
    prefix cache's key and the directory's digest."""
    return hashlib.blake2b(
        np.ascontiguousarray(tokens, np.int32).tobytes(), digest_size=16
    ).digest()


def wire_dtype(name: str) -> np.dtype:
    """The numpy dtype a wire leaf named ``name`` is held in: bfloat16 as
    its raw 2-byte words (``uint16``), every other name as itself."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


@dataclass
class TierConfig:
    """Capacity/wiring knobs for a :class:`TieredStore`.

    Capacities are **entry counts** (same unit as the prefix cache's
    ``max_entries``), so "host+disk = 4x the HBM cache" is a direct
    knob-to-knob statement and the ghost shadows can report headroom
    beyond the *total* (HBM+host+disk) capacity. Optional byte caps
    bound the actual RAM/disk footprint underneath. A tier with 0
    entries is disabled (a host-tier-only deployment just leaves
    ``disk_entries`` at 0)."""

    host_entries: int = 64
    disk_entries: int = 0
    disk_dir: Optional[str] = None
    host_bytes: Optional[int] = None
    disk_bytes: Optional[int] = None
    # pages installed per scheduler iteration on restore: the batch knob
    # that lets a restore overlap other slots' decode steps instead of
    # stalling the loop for the whole prefix
    restore_batch_pages: int = 4
    # ((name, base_url), ...) of peer replicas for the fleet tier
    peers: tuple = ()
    peer_ttl_s: float = 2.0

    def entry_capacity(self) -> int:
        """Entries the host+disk tiers can hold — what the ghost
        shadows add to the HBM cache's ``max_entries`` so their
        "would a bigger cache help?" answer measures headroom beyond
        the capacity that now exists."""
        return max(0, int(self.host_entries)) + max(0, int(self.disk_entries))


@dataclass
class TierEntry:
    """One demoted prefix, host-resident form: the handoff blob's
    payload as live numpy arrays (page axis = ``n_pages``), in wire
    order. ``dtypes`` are the leaves' wire dtype names (default: each
    array's own; a bf16 leaf is a ``uint16`` array named "bfloat16")."""

    key: bytes                 # _digest(tokens)
    token_len: int
    tokens: np.ndarray         # int32 [token_len]
    n_pages: int
    arrays: list               # one np array per K/V leaf
    paths: list                # leaf identity (handoff wire paths)
    nbytes: int
    tenant: str = "default"
    last_used: int = 0
    dtypes: Optional[list] = None
    _indexed: list = field(default_factory=list, repr=False)

    def dtype_names(self) -> list:
        return list(self.dtypes) if self.dtypes else [a.dtype.name for a in self.arrays]


def entry_nbytes(arrays, tokens) -> int:
    return int(sum(int(a.nbytes) for a in arrays) + int(tokens.nbytes))


def _page_axis(arr) -> int:
    # same rank convention as pages._KV_NDIM: page axis is ndim - 4
    return arr.ndim - 4


def slice_entry_pages(entry: TierEntry, token_len: int, page_size: int):
    """(tokens, arrays) for a page-aligned *prefix* of a stored entry —
    a longer demoted entry serves every shorter aligned prefix, so the
    tiers never store the same page twice across lengths."""
    n_pages = -(-token_len // page_size)
    if token_len == entry.token_len:
        return entry.tokens, entry.arrays
    arrays = [
        np.take(a, range(n_pages), axis=_page_axis(a)) for a in entry.arrays
    ]
    return entry.tokens[:token_len], arrays


def blob_checksum(doc: dict) -> str:
    """Content checksum over everything the install path will trust:
    header fields, tokens, and the raw leaf bytes — a torn or bit-
    flipped blob fails this before any page is written."""
    h = hashlib.blake2b(digest_size=16)
    h.update((
        f"{doc.get('version')}|{doc.get('page_size')}|"
        f"{doc.get('kv_cache_dtype')}|{doc.get('token_len')}|"
        f"{doc.get('n_pages')}|"
    ).encode())
    h.update(np.asarray(doc.get("tokens") or [], np.int32).tobytes())
    for leaf in doc.get("leaves") or []:
        h.update(
            f"{leaf.get('path')}|{leaf.get('dtype')}|{leaf.get('shape')}|".encode()
        )
        try:
            h.update(base64.b64decode(leaf.get("data") or ""))
        except (ValueError, TypeError):
            h.update(b"?")
    return h.hexdigest()


def entry_to_handoff(entry: TierEntry, *, page_size: int, kv_cache_dtype: str,
                     replica=None, token_len: Optional[int] = None) -> dict:
    """Serialize a tier entry (or an aligned prefix of it) to the
    handoff wire dict — THE serialization format of every tier."""
    length = entry.token_len if token_len is None else int(token_len)
    tokens, arrays = slice_entry_pages(entry, length, page_size)
    leaves = []
    for path, name, arr in zip(entry.paths, entry.dtype_names(), arrays):
        leaves.append({
            "path": path,
            "dtype": name,
            "shape": list(arr.shape),
            "data": base64.b64encode(
                np.ascontiguousarray(arr).tobytes()
            ).decode("ascii"),
        })
    return {
        "version": 1,
        "page_size": int(page_size),
        "kv_cache_dtype": kv_cache_dtype,
        "token_len": int(length),
        "tokens": [int(t) for t in tokens],
        "n_pages": -(-length // page_size),
        "replica": replica,
        "leaves": leaves,
    }


def handoff_to_entry(doc: dict, tenant: str = "default") -> TierEntry:
    """Parse a handoff dict back into a host-resident entry (the disk
    tier's read path and the peer tier's pull). Raises ValueError on a
    malformed document; checksum verification is the caller's job (only
    disk blobs carry one)."""
    tokens = np.asarray(doc["tokens"], np.int32).reshape(-1)
    token_len = int(doc["token_len"])
    n_pages = int(doc["n_pages"])
    if tokens.size != token_len:
        raise ValueError("KV blob token accounting is inconsistent")
    arrays, paths, dtypes = [], [], []
    for leaf in doc["leaves"]:
        arr = np.frombuffer(
            base64.b64decode(leaf["data"]), wire_dtype(leaf["dtype"])
        ).reshape(leaf["shape"])
        if arr.ndim < 4 or arr.shape[_page_axis(arr)] != n_pages:
            raise ValueError(f"KV blob leaf {leaf.get('path')!r} page count "
                             "does not match n_pages")
        arrays.append(arr)
        paths.append(leaf["path"])
        dtypes.append(str(leaf["dtype"]))
    if not arrays:
        raise ValueError("KV blob carries no leaves")
    return TierEntry(
        key=_digest(tokens), token_len=token_len, tokens=tokens,
        n_pages=n_pages, arrays=arrays, paths=paths,
        nbytes=entry_nbytes(arrays, tokens),
        tenant=str(doc.get("tenant") or tenant), dtypes=dtypes,
    )


def _http_json(base_url: str, path: str, payload=None, timeout_s: float = 5.0):
    """Minimal JSON-over-HTTP helper for the peer tier (GET when
    ``payload`` is None, POST otherwise). Returns the parsed body or
    None on any transport/decode/status failure — a peer pull is an
    optimization; its failure is a miss, never an exception."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(base_url)
    conn = http.client.HTTPConnection(
        u.hostname, u.port or 80, timeout=timeout_s
    )
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            body = json.dumps(payload).encode()
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            return None
        return json.loads(data)
    except (OSError, ValueError):
        return None
    finally:
        conn.close()


class _LruIndex:
    """Shared host/disk bookkeeping: an entry table keyed by full-prefix
    digest plus a prefix index mapping every page-aligned prefix digest
    of every entry to ``(entry_key, prefix_len)`` — so one long demoted
    entry serves all its shorter aligned prefixes and the tiers never
    hold the same pages twice."""

    def __init__(self, max_entries: int, max_bytes: Optional[int]):
        self.max_entries = max(0, int(max_entries))
        self.max_bytes = int(max_bytes) if max_bytes else None
        self.entries: dict = {}   # key -> TierEntry | disk stub dict
        self.index: dict = {}     # prefix digest -> {entry_key: prefix_len}
        self.nbytes = 0
        self._clock = 0

    def tick(self) -> int:
        self._clock += 1
        return self._clock

    def register(self, key: bytes, tokens: np.ndarray, token_len: int,
                 page_size: int) -> list:
        """Index every aligned prefix (+ the full length) of an entry;
        returns the (digest, key) pairs registered for later cleanup."""
        lengths = list(range(page_size, token_len + 1, page_size))
        if token_len % page_size:
            lengths.append(token_len)
        indexed = []
        for length in lengths:
            d = key if length == token_len else _digest(tokens[:length])
            self.index.setdefault(d, {})[key] = length
            indexed.append(d)
        return indexed

    def unregister(self, key: bytes, indexed: list):
        for d in indexed:
            slot = self.index.get(d)
            if slot is not None:
                slot.pop(key, None)
                if not slot:
                    del self.index[d]

    def probe(self, digest: bytes):
        """(entry_key, prefix_len) of any entry covering ``digest``,
        preferring the most recently used cover, or None."""
        slot = self.index.get(digest)
        if not slot:
            return None
        best = max(
            slot, key=lambda k: getattr(
                self.entries.get(k), "last_used",
                (self.entries.get(k) or {}).get("last_used", 0)
                if isinstance(self.entries.get(k), dict) else 0,
            ),
        )
        if best not in self.entries:
            return None
        return best, slot[best]

    def over_capacity(self) -> bool:
        if len(self.entries) > self.max_entries:
            return True
        return self.max_bytes is not None and self.nbytes > self.max_bytes

    def lru_key(self):
        if not self.entries:
            return None
        return min(
            self.entries, key=lambda k: (
                self.entries[k].last_used
                if isinstance(self.entries[k], TierEntry)
                else self.entries[k].get("last_used", 0)
            ),
        )


class TieredStore:
    """Host RAM → disk → peer prefix store behind the HBM prefix cache.

    ``put()`` is the demote-on-evict sink (HBM eviction feeds it); host
    overflow demotes the host LRU entry onward to disk; disk overflow
    deletes the disk LRU blob — eviction always cascades *down*, never
    sideways. ``probe()`` is the admission-side lookup, longest aligned
    prefix first across host → disk → peer directories. All byte
    movement reports through the ``on_bytes(tenant, tier, delta)`` hook
    (the usage accountant's byte-seconds meter) with the same symmetric
    contract as the engine's page hooks: every + has a matching −, so
    held bytes drain to exactly 0."""

    def __init__(self, config: TierConfig, *, page_size: int,
                 kv_cache_dtype: str = "bf16", replica=None,
                 on_bytes: Optional[Callable] = None,
                 fetch: Optional[Callable] = None,
                 clock=time.monotonic):
        self.config = config
        self.page_size = int(page_size)
        self.kv_cache_dtype = kv_cache_dtype or "bf16"
        self.replica = replica
        self.on_bytes = on_bytes
        self._fetch = fetch or _http_json
        self._clock = clock
        self.host = _LruIndex(config.host_entries, config.host_bytes)
        self.disk = _LruIndex(
            config.disk_entries if config.disk_dir else 0, config.disk_bytes
        )
        # peer directory cache: name -> (fetched_at, {digest_hex: token_len})
        self._peer_dirs: dict = {}
        # counters (engine merges these into serving/ metrics); set before
        # the disk scan, which counts the corrupt blobs it finds
        self.demotions_host = 0
        self.demotions_disk = 0
        self.disk_corrupt_dropped = 0
        self.peer_pulls = 0
        self.peer_pull_failures = 0
        if config.disk_dir:
            os.makedirs(config.disk_dir, exist_ok=True)
            self._scan_disk()

    # -- byte accounting ----------------------------------------------------

    def _note_bytes(self, tenant: str, tier: str, delta: int):
        if self.on_bytes is not None and delta:
            self.on_bytes(tenant, tier, int(delta))

    # -- demotion sink (HBM -> host -> disk) --------------------------------

    def covers(self, key: bytes) -> bool:
        """Whether some tier entry already serves this exact prefix —
        the demote path's dedup check (re-demoting a prefix a longer
        entry already covers would store the same pages twice)."""
        return key in self.host.index or key in self.disk.index

    def put(self, entry: TierEntry):
        """Demote one evicted prefix into the host tier (cascading the
        host LRU victim to disk, and the disk LRU victim to oblivion,
        as capacity requires). No-op when the host tier is disabled or
        the prefix is already covered."""
        if self.host.max_entries <= 0 or entry.key in self.host.entries:
            return
        entry.last_used = self.host.tick()
        entry._indexed = self.host.register(
            entry.key, entry.tokens, entry.token_len, self.page_size
        )
        self.host.entries[entry.key] = entry
        self.host.nbytes += entry.nbytes
        self.demotions_host += 1
        self._note_bytes(entry.tenant, "host", entry.nbytes)
        while self.host.over_capacity():
            victim_key = self.host.lru_key()
            if victim_key is None:
                break
            victim = self.host.entries.pop(victim_key)
            self.host.unregister(victim_key, victim._indexed)
            self.host.nbytes -= victim.nbytes
            self._note_bytes(victim.tenant, "host", -victim.nbytes)
            self._demote_to_disk(victim)

    def _demote_to_disk(self, entry: TierEntry):
        if self.disk.max_entries <= 0 or entry.key in self.disk.entries:
            return
        doc = entry_to_handoff(
            entry, page_size=self.page_size,
            kv_cache_dtype=self.kv_cache_dtype, replica=self.replica,
        )
        doc["tenant"] = entry.tenant
        doc["checksum"] = blob_checksum(doc)
        path = os.path.join(
            self.config.disk_dir, entry.key.hex() + BLOB_SUFFIX
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        nbytes = os.path.getsize(path)
        stub = {
            "path": path, "token_len": entry.token_len, "nbytes": nbytes,
            "tenant": entry.tenant, "last_used": self.disk.tick(),
            "indexed": self.disk.register(
                entry.key, entry.tokens, entry.token_len, self.page_size
            ),
        }
        self.disk.entries[entry.key] = stub
        self.disk.nbytes += nbytes
        self.demotions_disk += 1
        self._note_bytes(entry.tenant, "disk", nbytes)
        while self.disk.over_capacity():
            victim_key = self.disk.lru_key()
            if victim_key is None:
                break
            self._drop_disk(victim_key)

    def _drop_disk(self, key: bytes):
        stub = self.disk.entries.pop(key, None)
        if stub is None:
            return
        self.disk.unregister(key, stub["indexed"])
        self.disk.nbytes -= stub["nbytes"]
        self._note_bytes(stub["tenant"], "disk", -stub["nbytes"])
        try:
            os.unlink(stub["path"])
        except OSError:
            pass

    def _scan_disk(self):
        """Rebuild the disk index from blobs left by a previous process
        — a disk tier is durable storage, so a restarted replica serves
        session resumes across its own restart. Corrupt blobs found
        here are dropped and counted, same as on the probe path."""
        try:
            names = sorted(os.listdir(self.config.disk_dir))
        except OSError:
            return
        for name in names:
            if not name.endswith(BLOB_SUFFIX):
                continue
            path = os.path.join(self.config.disk_dir, name)
            doc = self._read_blob(path)
            if doc is None:
                continue
            try:
                tokens = np.asarray(doc["tokens"], np.int32).reshape(-1)
                token_len = int(doc["token_len"])
                key = _digest(tokens)
            except (KeyError, ValueError, TypeError):
                self._reject_blob(path)
                continue
            if key in self.disk.entries:
                continue
            nbytes = os.path.getsize(path)
            self.disk.entries[key] = {
                "path": path, "token_len": token_len, "nbytes": nbytes,
                "tenant": str(doc.get("tenant") or "default"),
                "last_used": self.disk.tick(),
                "indexed": self.disk.register(
                    key, tokens, token_len, self.page_size
                ),
            }
            self.disk.nbytes += nbytes
            self._note_bytes(
                str(doc.get("tenant") or "default"), "disk", nbytes
            )

    def _read_blob(self, path: str) -> Optional[dict]:
        """Parse + checksum-verify one disk blob; on ANY failure (torn
        write, truncation, bit flip, schema drift) the blob is deleted
        and counted — a corrupt page must never be installed."""
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            self._reject_blob(path)
            return None
        if not isinstance(doc, dict) or doc.get("version") != 1 \
                or int(doc.get("page_size") or 0) != self.page_size \
                or (doc.get("kv_cache_dtype") or "bf16") != self.kv_cache_dtype \
                or doc.get("checksum") != blob_checksum(doc):
            self._reject_blob(path)
            return None
        return doc

    def _reject_blob(self, path: str):
        self.disk_corrupt_dropped += 1
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- admission-side probe (host -> disk -> peer, longest first) ---------

    def _candidate_lengths(self, n: int, min_len: int) -> list:
        ps = self.page_size
        lengths = list(range(ps, n + 1, ps))
        if n % ps:
            lengths.append(n)
        return [length for length in sorted(lengths, reverse=True)
                if length > min_len]

    def probe(self, tokens: np.ndarray, limit: Optional[int] = None,
              min_len: int = 0) -> Optional[dict]:
        """Longest tier-resident prefix of ``tokens`` strictly longer
        than ``min_len`` (the HBM cache's own best — a tier restore
        shorter than what HBM already serves is pure waste). Returns
        ``{"tier", "token_len", "tokens", "arrays"}`` for host/disk
        hits, ``{"tier": "peer", "handoff": ...}`` for a peer pull, or
        None."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = int(tokens.size if limit is None else min(tokens.size, limit))
        memo: dict = {}

        def dig(length):
            d = memo.get(length)
            if d is None:
                d = memo[length] = _digest(tokens[:length])
            return d

        for length in self._candidate_lengths(n, min_len):
            d = dig(length)
            hit = self.host.probe(d)
            if hit is not None:
                entry = self.host.entries[hit[0]]
                entry.last_used = self.host.tick()
                toks, arrays = slice_entry_pages(entry, length, self.page_size)
                return {"tier": "host", "token_len": length,
                        "tokens": toks, "arrays": arrays,
                        "paths": entry.paths}
            hit = self.disk.probe(d)
            if hit is not None:
                got = self._restore_from_disk(hit[0], length)
                if got is not None:
                    return got
            got = self._pull_from_peer(d, tokens[:length], length)
            if got is not None:
                return got
        return None

    def _restore_from_disk(self, key: bytes, length: int) -> Optional[dict]:
        stub = self.disk.entries.get(key)
        if stub is None:
            return None
        doc = self._read_blob(stub["path"])
        if doc is None:
            # rejected (torn/corrupt): forget the stub so the probe
            # falls through to the peer tier / cold prefill
            stub = self.disk.entries.pop(key, None)
            if stub is not None:
                self.disk.unregister(key, stub["indexed"])
                self.disk.nbytes -= stub["nbytes"]
                self._note_bytes(stub["tenant"], "disk", -stub["nbytes"])
            return None
        try:
            entry = handoff_to_entry(doc)
        except (KeyError, ValueError, TypeError):
            self._reject_blob(stub["path"])
            self.disk.entries.pop(key, None)
            self.disk.unregister(key, stub["indexed"])
            self.disk.nbytes -= stub["nbytes"]
            self._note_bytes(stub["tenant"], "disk", -stub["nbytes"])
            return None
        stub["last_used"] = self.disk.tick()
        toks, arrays = slice_entry_pages(entry, length, self.page_size)
        return {"tier": "disk", "token_len": length, "tokens": toks,
                "arrays": arrays, "paths": entry.paths}

    # -- peer tier -----------------------------------------------------------

    def _peer_directory(self, name: str, url: str) -> dict:
        now = self._clock()
        cached = self._peer_dirs.get(name)
        if cached is not None and now - cached[0] < self.config.peer_ttl_s:
            return cached[1]
        doc = self._fetch(url, "/v1/kv/directory") or {}
        dirmap = {
            str(row.get("digest")): int(row.get("token_len") or 0)
            for row in (doc.get("prefixes") or [])
            if isinstance(row, dict)
        }
        self._peer_dirs[name] = (now, dirmap)
        return dirmap

    def _pull_from_peer(self, digest: bytes, tokens: np.ndarray,
                        length: int) -> Optional[dict]:
        if not self.config.peers:
            return None
        hexd = digest.hex()
        for name, url in self.config.peers:
            if hexd not in self._peer_directory(name, url):
                continue
            handoff = self._fetch(
                url, "/v1/kv/export", {"tokens": [int(t) for t in tokens]}
            )
            if not isinstance(handoff, dict) or not handoff.get("token_len"):
                # directory was stale (peer evicted since advertising):
                # count it and keep probing — the next length/peer may hit
                self.peer_pull_failures += 1
                continue
            self.peer_pulls += 1
            return {"tier": "peer", "token_len": int(handoff["token_len"]),
                    "handoff": handoff}
        return None

    # -- housekeeping --------------------------------------------------------

    def clear(self):
        """Drop every tier entry (bytes drain through the hook — the
        leak tests assert held bytes return to exactly 0)."""
        for key in list(self.host.entries):
            entry = self.host.entries.pop(key)
            self.host.unregister(key, entry._indexed)
            self.host.nbytes -= entry.nbytes
            self._note_bytes(entry.tenant, "host", -entry.nbytes)
        for key in list(self.disk.entries):
            self._drop_disk(key)
        self._peer_dirs.clear()

    def gauges(self) -> dict:
        """``serving/kv_*`` gauge fragment the engine merges into
        :meth:`~.engine.ServingEngine.metrics` (fleet merge policies in
        ``telemetry/fleet.py`` know each key's algebra)."""
        out = {
            "serving/kv_host_entries": len(self.host.entries),
            "serving/kv_host_bytes": self.host.nbytes,
            "serving/kv_demotions_host": self.demotions_host,
        }
        if self.config.disk_dir:
            out["serving/kv_disk_entries"] = len(self.disk.entries)
            out["serving/kv_disk_bytes"] = self.disk.nbytes
            out["serving/kv_demotions_disk"] = self.demotions_disk
            out["serving/kv_disk_corrupt_dropped"] = self.disk_corrupt_dropped
        if self.config.peers:
            out["serving/kv_peer_pulls"] = self.peer_pulls
            out["serving/kv_peer_pull_failures"] = self.peer_pull_failures
        return out
