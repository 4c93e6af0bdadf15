"""Durable JSONL artifact retention: one writer, one reader discipline.

An own copy of the reference's ``accelerate_tpu/telemetry/artifacts.py``:
the same rotation chain and generation naming, so the reference's readers
read the port's files and the reverse.

Every observability plane in the repo persists line-delimited JSON —
request records, alert events, timeline samples, router/autoscale
decisions, canary results, fleet events. Until this module each writer
hand-rolled ``open(path, "a")`` and grew without bound: a week-long
serve loop turns ``requests-host0.jsonl`` into the disk-full incident
the telemetry was supposed to prevent. :class:`ArtifactWriter` is the
single append path:

- **atomic appends** — each record is one unbuffered ``write()`` on an
  ``O_APPEND`` descriptor, so a ``kill -9`` mid-append can only ever
  tear the *last* line, never corrupt an earlier record (every family's
  reader already skips unparseable lines; this makes that the whole
  failure mode);
- **size/age-based rotation** — when the active file would exceed
  ``max_bytes`` (or outlives ``max_age_s``) it is renamed to ``.1``
  (shifting ``.1 -> .2`` and so on) and a fresh active file opens;
  generations beyond ``max_generations`` are deleted oldest-first. The
  active generation is never truncated or lost: rotation is a rename
  chain, highest suffix first;
- **multi-generation reads** — :func:`artifact_files` expands a reader's
  glob to every surviving generation, oldest first, so ``load_alerts``
  / ``load_timeline`` / the incident correlator see one continuous
  stream across rotations.

Plain stdlib: artifacts are written and read wherever the log files land.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import re
import threading
import time
from typing import Iterator, Optional

# a generation suffix is strictly numeric: ``alerts-host0.jsonl.3``
_GEN_RE = re.compile(r"^(?P<base>.+)\.(?P<gen>[0-9]+)$")

# defaults sized so an unconfigured long-running writer still holds a
# bounded footprint (~256 MB per family) without rotating mid-test
DEFAULT_MAX_BYTES = 64 * 1024 * 1024
DEFAULT_MAX_GENERATIONS = 3


class ArtifactWriter:
    """Append-only JSONL writer with bounded rotation.

    ``write(obj)`` serialises one record and appends it as a single
    unbuffered write; ``write_line(line)`` appends a pre-rendered line
    (a trailing newline is added when missing). Rotation happens *before*
    the append that would cross ``max_bytes``, so a single record is
    never split across generations. Thread-safe; close is idempotent.
    """

    def __init__(self, path: str, *, max_bytes: int = DEFAULT_MAX_BYTES,
                 max_age_s: Optional[float] = None,
                 max_generations: int = DEFAULT_MAX_GENERATIONS):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.max_age_s = None if max_age_s is None else float(max_age_s)
        self.max_generations = max(0, int(max_generations))
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self._opened_t = 0.0
        self.records_written = 0
        self.rotations = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._open()

    # -- the append path ----------------------------------------------------

    def _open(self):
        # unbuffered binary append: one write() per record, no partial
        # flush windows for a kill to land in
        self._fh = open(self.path, "ab", buffering=0)
        try:
            self._size = os.fstat(self._fh.fileno()).st_size
        except OSError:
            self._size = 0
        self._opened_t = time.time()

    def _rotate_locked(self):
        """Shift generations highest-first (``.2 -> .3``, ``.1 -> .2``,
        active ``-> .1``) and reopen a fresh active file. The active
        generation survives every step: each move is a single rename."""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self.max_generations <= 0:
            # no retained generations: the rotated-out file is dropped
            try:
                os.remove(self.path)
            except OSError:
                pass
        else:
            # delete anything at/beyond the cap, then shift down
            for gen in sorted(
                (int(m.group("gen")) for m in
                 (_GEN_RE.match(p) for p in _glob.glob(self.path + ".*"))
                 if m is not None),
                reverse=True,
            ):
                src = f"{self.path}.{gen}"
                if gen >= self.max_generations:
                    try:
                        os.remove(src)
                    except OSError:
                        pass
                else:
                    try:
                        os.replace(src, f"{self.path}.{gen + 1}")
                    except OSError:
                        pass
            try:
                os.replace(self.path, self.path + ".1")
            except OSError:
                pass
        self.rotations += 1
        self._open()

    def write_line(self, line: str):
        data = line if line.endswith("\n") else line + "\n"
        payload = data.encode("utf-8")
        with self._lock:
            if self._fh is None:
                return
            now = time.time()
            if (self._size and self._size + len(payload) > self.max_bytes) or (
                self.max_age_s is not None
                and now - self._opened_t > self.max_age_s
            ):
                self._rotate_locked()
            try:
                self._fh.write(payload)
                self._size += len(payload)
                self.records_written += 1
            except OSError:
                pass  # a full disk must not take the serving loop down

    def write(self, obj):
        self.write_line(json.dumps(obj, default=str))

    def flush(self):
        """Kept for drop-in parity with the file handles this replaces;
        the descriptor is unbuffered so every record is already on its
        way to the kernel."""

    @property
    def closed(self) -> bool:
        return self._fh is None

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


# -- readers ----------------------------------------------------------------


def artifact_files(target, pattern: Optional[str] = None) -> list:
    """Every surviving generation of every artifact matching ``pattern``
    under ``target`` (a dir, a file path, or a list of either), ordered
    oldest-generation-first per base file — the one expansion every
    family's loader shares, so rotated history reads as one stream.

    ``artifact_files("/dir", "alerts-host*.jsonl")`` returns
    ``[alerts-host0.jsonl.2, alerts-host0.jsonl.1, alerts-host0.jsonl,
    alerts-host1.jsonl, ...]``.
    """
    targets = [target] if isinstance(target, str) else list(target)
    bases = []
    for t in targets:
        if os.path.isdir(t):
            if pattern:
                bases.extend(sorted(_glob.glob(os.path.join(t, pattern))))
        else:
            bases.append(t)
    out = []
    for base in bases:
        gens = []
        for p in _glob.glob(base + ".*"):
            m = _GEN_RE.match(p)
            if m is not None:
                gens.append((int(m.group("gen")), p))
        out.extend(p for _, p in sorted(gens, reverse=True))
        if os.path.exists(base):
            out.append(base)
    return out


def iter_jsonl(paths) -> Iterator[dict]:
    """Torn-line-safe record iterator over a path list (what
    :func:`artifact_files` returns): unreadable files and unparseable
    lines — including a line torn by a mid-append kill — are skipped,
    never raised."""
    for path in paths:
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        yield rec
        except OSError:
            continue


def read_jsonl(target, pattern: Optional[str] = None) -> list:
    """All records of one artifact family under ``target``, across every
    generation, in write order per file."""
    return list(iter_jsonl(artifact_files(target, pattern)))
