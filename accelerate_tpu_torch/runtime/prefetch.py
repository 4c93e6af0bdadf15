"""Host-side prefetch: assemble the next batches while the card computes.

Counterpart of ``accelerate_tpu/runtime/prefetch.py``. :class:`RingBuffer`
drives the native slot ring of ``csrc/host_runtime.cpp`` (``host_ring_*``;
there is no Python ring behind it: a failed build raises).
:class:`HostPrefetcher` runs a producer thread that pulls batches from any
iterator and copies each into a ring slot with the native parallel copy,
up to ``depth`` batches ahead of the consumer.

A slot holds one batch of the layout the first batch sets: a dict whose
fields (numpy arrays or CPU tensors, in sorted key order) each start at a
64-byte-aligned offset. A batch that does not match that layout (the
ragged last batch, a batch that is not a dict, a tensor off the CPU)
goes through a side channel as the object itself, the slot left
untouched. The consumer copies each batch out of its slot before it
releases the slot, so the producer never overwrites a batch in use (the
copy to the card happens later, from the consumer's own memory). An
error in the producer is raised in the consumer after the batches before
it; ``close()`` wakes both sides and ends the producer thread, also when
the consumer abandons the epoch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from . import native


class RingBuffer:
    """``slots`` byte buffers of ``slot_bytes`` each between one producer
    (``acquire_fill`` -> write -> ``commit_fill``) and one consumer
    (``acquire_read`` -> read -> ``release_read``); both acquires return
    -1 once the ring is closed (the consumer's when nothing committed is
    left)."""

    def __init__(self, slots: int, slot_bytes: int):
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self._lib = native.ring_lib()
        self._ring = self._lib.host_ring_create(self.slots, self.slot_bytes)
        if not self._ring:
            raise MemoryError(f"host_ring_create({self.slots}, {self.slot_bytes}) failed")

    def acquire_fill(self) -> int:
        return self._lib.host_ring_acquire_fill(self._ring)

    def commit_fill(self, slot: int) -> None:
        self._lib.host_ring_commit_fill(self._ring, slot)

    def acquire_read(self) -> int:
        return self._lib.host_ring_acquire_read(self._ring)

    def release_read(self, slot: int) -> None:
        self._lib.host_ring_release_read(self._ring, slot)

    def slot_address(self, slot: int) -> int:
        return self._lib.host_ring_slot_ptr(self._ring, slot)

    def slot_view(self, slot: int) -> torch.Tensor:
        """A uint8 tensor over the slot's storage (no copy)."""
        buf = (ctypes.c_uint8 * self.slot_bytes).from_address(self.slot_address(slot))
        return torch.frombuffer(buf, dtype=torch.uint8)

    def close(self) -> None:
        self._lib.host_ring_close(self._ring)

    def __del__(self):
        ring = getattr(self, "_ring", None)
        if ring:
            self._ring = None
            self._lib.host_ring_destroy(ring)


def _as_field(value):
    """A dict field as the producer keeps it: tensors and numpy arrays as
    they are, anything else through ``np.asarray`` (the reference's)."""
    return value if isinstance(value, (torch.Tensor, np.ndarray)) else np.asarray(value)


def _address(x) -> int:
    return x.data_ptr() if isinstance(x, torch.Tensor) else x.ctypes.data


class HostPrefetcher:
    """Iterate ``source`` with a producer thread ``depth`` (at least 2)
    batches ahead. ``transform`` runs on each batch on the consumer's
    side; ``copy_threads`` native threads copy a batch's fields into its
    slot."""

    THREAD_NAME = "HostPrefetcher"

    def __init__(self, source: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None, copy_threads: int = 4):
        self.source = iter(source)
        self.depth = max(2, depth)
        self.transform = transform
        self.copy_threads = copy_threads
        self._ring: Optional[RingBuffer] = None
        # [(key, shape, dtype, byte offset, nbytes, is_tensor)]
        self._layout = None
        self._slot_bytes = 0
        self._thread: Optional[threading.Thread] = None
        self._error = None

    # -- the producer ----------------------------------------------------

    def _init_layout(self, first) -> None:
        offset, layout = 0, []
        if isinstance(first, dict):
            for key in sorted(first):
                x = first[key]
                if isinstance(x, torch.Tensor):
                    if x.device.type != "cpu":
                        layout, offset = [], 0
                        break
                    nbytes = x.numel() * x.element_size()
                    layout.append((key, tuple(x.shape), x.dtype, offset, nbytes, True))
                else:
                    if x.dtype.hasobject:
                        layout, offset = [], 0
                        break
                    nbytes = x.nbytes
                    layout.append((key, x.shape, x.dtype, offset, nbytes, False))
                offset += (nbytes + 63) // 64 * 64  # each field 64-byte aligned
        self._layout = layout
        self._slot_bytes = max(offset, 64)
        self._ring = RingBuffer(self.depth, self._slot_bytes)
        # the side channel: a batch off the layout, per slot
        self._slot_objects = [None] * self.depth
        self._in_slot = [False] * self.depth

    def _matches_layout(self, batch) -> bool:
        if not self._layout or not isinstance(batch, dict):
            return False
        if set(batch) != {f[0] for f in self._layout}:
            return False
        for key, shape, dtype, _, _, is_tensor in self._layout:
            x = batch[key]
            if is_tensor != isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(shape):
                return False
            if x.dtype != dtype or (is_tensor and x.device.type != "cpu"):
                return False
        return True

    def _fill(self, slot: int, batch) -> None:
        if not self._matches_layout(batch):
            self._slot_objects[slot] = batch
            self._in_slot[slot] = False
            return
        self._slot_objects[slot] = None
        self._in_slot[slot] = True
        base = self._ring.slot_address(slot)
        keep, copies = [], []
        for key, _, _, off, nbytes, is_tensor in self._layout:
            x = batch[key]
            x = x.detach().contiguous() if is_tensor else np.ascontiguousarray(x)
            keep.append(x)
            if nbytes:
                copies.append((base + off, _address(x), nbytes))
        native.parallel_memcpy(copies, num_threads=self.copy_threads)

    def _producer(self) -> None:
        try:
            for batch in self.source:
                if isinstance(batch, dict):
                    batch = {k: _as_field(v) for k, v in batch.items()}
                if self._layout is None:
                    self._init_layout(batch)
                    self._started.set()
                slot = self._ring.acquire_fill()
                if slot < 0:  # closed by the consumer
                    return
                self._fill(slot, batch)
                self._ring.commit_fill(slot)
        except Exception as e:  # raised again in the consumer
            self._error = e
        finally:
            if self._ring is not None:
                self._ring.close()
            self._started.set()

    # -- the consumer ----------------------------------------------------

    def _read(self, slot: int):
        if not self._in_slot[slot]:
            batch, self._slot_objects[slot] = self._slot_objects[slot], None
            return batch
        base = self._ring.slot_address(slot)
        batch, copies = {}, []
        for key, shape, dtype, off, nbytes, is_tensor in self._layout:
            out = torch.empty(shape, dtype=dtype) if is_tensor else np.empty(shape, dtype)
            batch[key] = out
            if nbytes:
                copies.append((_address(out), base + off, nbytes))
        native.parallel_memcpy(copies, num_threads=self.copy_threads)
        return batch

    def __iter__(self):
        self._error = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._producer, name=self.THREAD_NAME,
                                        daemon=True)
        self._thread.start()
        self._started.wait()
        try:
            while self._ring is not None:
                slot = self._ring.acquire_read()
                if slot < 0:
                    break
                batch = self._read(slot)  # a copy: the slot is free for reuse now
                self._ring.release_read(slot)
                yield self.transform(batch) if self.transform else batch
        finally:
            self.close()
        if self._error is not None:
            raise self._error

    def close(self) -> None:
        """Close the ring (waking both sides) and wait for the producer
        thread to end."""
        if self._ring is not None:
            self._ring.close()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join()
