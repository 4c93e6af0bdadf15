"""The port's host prefetch ring (``runtime/prefetch.py`` over
``csrc/host_runtime.cpp``) against the JAX package's, on the CPU.

- ``HostPrefetcher`` against the reference's ``HostPrefetcher`` on the
  same sources, batches from a numpy seed: several dtypes, a ragged last
  batch, a batch that is not a dict, list fields, an empty source, a
  producer error after some batches, an early ``close``. The same
  batches in the same order, exactly (values, dtypes, shapes); the same
  error after them; the producer thread gone after ``close``.
- The port's own: dicts of CPU tensors (bf16 among them) come back as
  tensors, bit for bit; a CUDA-less tensor elsewhere goes through the
  side channel; the ring's slots are 64-byte aligned, its order FIFO,
  and ``close`` wakes a consumer blocked in another thread; a failed
  g++ build raises in the consumer (no Python ring behind it).
- A prepared loader with ``prefetch_depth=3`` against the same loader
  without: batches, ``end_of_dataloader`` on each step, ``state_dict``
  after each batch, a resume from each position and
  ``skip_first_batches``; the producer thread ends with the epoch and
  after an early ``break``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from accelerate_tpu.runtime.prefetch import HostPrefetcher as RefPrefetcher
from accelerate_tpu_torch import Accelerator, DataLoader, DataLoaderConfiguration
from accelerate_tpu_torch.runtime import native
from accelerate_tpu_torch.runtime.prefetch import HostPrefetcher, RingBuffer

DTYPES = (np.float32, np.int64, np.uint8, np.bool_, np.float16, np.int32)


def _batch(rng, b):
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (b, 1 + i % 3, 5)
        if dt == np.bool_:
            out[f"f{i}"] = rng.rand(*shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            out[f"f{i}"] = rng.randint(0, 120, shape).astype(dt)
        else:
            out[f"f{i}"] = rng.standard_normal(shape).astype(dt)
    out["ids"] = [int(x) for x in rng.randint(0, 9, b)]  # a list field: np.asarray'd
    return out


def _source(seed, n=7, b=4, ragged=True, odd_at=None):
    rng = np.random.RandomState(seed)
    items = [_batch(rng, b) for _ in range(n)]
    if ragged:
        items.append(_batch(rng, b - 1))
    if odd_at is not None:
        items.insert(odd_at, ("not", "a dict", rng.randint(0, 9, 3)))
    return items


def _equal(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(sorted(got)) == list(sorted(want))
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bool else got,
                           want.view(torch.uint8) if want.dtype == torch.bool else want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        assert got == want


def _drain(cls, source, depth):
    out, error = [], None
    try:
        for batch in cls(iter(source), depth=depth):
            out.append(batch)
    except Exception as e:  # the producer's error, after the batches before it
        error = (type(e), str(e))
    return out, error


CASES = {
    "uniform": dict(ragged=False),
    "ragged last": dict(),
    "non-dict first": dict(odd_at=0),
    "non-dict middle": dict(odd_at=3),
    "one batch": dict(n=1, ragged=False),
}


@pytest.mark.parametrize("depth", [2, 3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefetcher_matches_the_reference(case, depth):
    source = _source(seed=depth, **CASES[case])
    got, got_err = _drain(HostPrefetcher, source, depth)
    want, want_err = _drain(RefPrefetcher, source, depth)
    assert got_err is None and want_err is None
    assert len(got) == len(want) == len(source)
    for g, w in zip(got, want):
        _equal(g, w)


def test_prefetcher_empty_source_and_producer_error_match_the_reference():
    assert _drain(HostPrefetcher, [], 2) == _drain(RefPrefetcher, [], 2) == ([], None)

    def failing():
        yield from _source(seed=0, n=3, ragged=False)
        raise ValueError("bad record 3")

    got, got_err = _drain(HostPrefetcher, failing(), 2)
    want, want_err = _drain(RefPrefetcher, failing(), 2)
    assert got_err == want_err == (ValueError, "bad record 3")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _equal(g, w)

    def failing_at_once():
        raise KeyError("first")
        yield  # noqa: unreachable: makes this a generator

    assert _drain(HostPrefetcher, failing_at_once(), 2)[1] == \
        _drain(RefPrefetcher, failing_at_once(), 2)[1]


def test_early_close_ends_the_producer_as_the_reference():
    source = _source(seed=1, n=40, ragged=False)
    for cls in (HostPrefetcher, RefPrefetcher):
        p = cls(iter(source), depth=2)
        it = iter(p)
        first = [next(it) for _ in range(3)]
        for g, w in zip(first, source[:3]):
            _equal(g, {k: np.asarray(v) for k, v in w.items()})
        p.close()
        p._thread.join(timeout=5)
        assert not p._thread.is_alive(), cls
    # the port's close() waits for the thread itself, and a generator
    # abandoned without close() closes the ring when it is collected
    p = HostPrefetcher(iter(source), depth=2)
    it = iter(p)
    next(it)
    p.close()
    assert not p._thread.is_alive()
    p = HostPrefetcher(iter(source), depth=2)
    it = iter(p)
    next(it)
    thread = p._thread
    del it
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_tensor_batches_come_back_as_tensors():
    gen = torch.Generator().manual_seed(0)
    source = [{"x": torch.randn(4, 8, generator=gen).to(torch.bfloat16),
               "m": torch.rand(4, 3, generator=gen) > 0.5,
               "i": torch.randint(0, 99, (4, 2), generator=gen),
               "t": torch.randn(2, 8, generator=gen).t()}  # not contiguous
              for _ in range(5)]
    source.append({"x": source[0]["x"][:2], "m": source[0]["m"][:2], "i": source[0]["i"][:2],
                   "t": source[0]["t"]})  # ragged: the side channel
    source.append({"x": torch.zeros(4, 8, dtype=torch.float32), "m": source[0]["m"],
                   "i": source[0]["i"], "t": source[0]["t"]})  # another dtype
    got = list(HostPrefetcher(iter(source), depth=3))
    assert len(got) == len(source)
    for g, w in zip(got, source):
        _equal(g, w)
    assert got[-2]["x"] is source[-2]["x"]  # passed through, not copied
    assert got[0]["x"] is not source[0]["x"]


def test_prefetchers_under_thread_stress():
    """More prefetchers than cores, each consumed by its own thread, with
    the interpreter switching threads every microsecond: every consumer
    gets its own batches, in order and exact."""
    n_threads, n_batches = 2 * (os.cpu_count() or 4), 150
    errors, done = [], []

    def consume(seed):
        rng = np.random.RandomState(seed)
        source = [{"x": rng.randint(0, 1 << 30, (3, 7)).astype(np.int64),
                   "y": np.full((2,), seed, np.float32)} for _ in range(n_batches)]
        try:
            got = list(HostPrefetcher(iter(source), depth=2, copy_threads=2))
            assert len(got) == n_batches
            for g, w in zip(got, source):
                _equal(g, w)
            done.append(seed)
        except Exception as e:  # reported by the main thread
            errors.append((seed, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and sorted(done) == list(range(n_threads))
    assert not _prefetch_threads()


def test_ring_order_alignment_and_close():
    ring = RingBuffer(3, 100)
    for slot in range(3):
        assert ring.slot_address(slot) % 64 == 0
    order = []
    for value in range(5):
        slot = ring.acquire_fill()
        ring.slot_view(slot)[:4] = torch.tensor([value] * 4, dtype=torch.uint8)
        ring.commit_fill(slot)
        read = ring.acquire_read()
        assert read == slot
        order.append(int(ring.slot_view(read)[0]))
        ring.release_read(read)
    assert order == list(range(5))
    got = []
    reader = threading.Thread(target=lambda: got.append(ring.acquire_read()))
    reader.start()
    time.sleep(0.05)
    assert reader.is_alive()  # blocked: nothing committed
    ring.close()
    reader.join(timeout=5)
    assert got == [-1] and ring.acquire_fill() == -1


def test_failed_ring_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILER", "false")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        list(HostPrefetcher(iter(_source(seed=0, n=2)), depth=2))
    with pytest.raises(RuntimeError, match="failed"):
        RingBuffer(2, 64)


class _Dataset:
    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, 1000, (n, 16)).astype(np.int64)
        self.w = rng.standard_normal((n, 3)).astype(np.float32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "weights": self.w[i]}


def _prepared(depth, n=22, shuffle=True):
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(prefetch_depth=depth))
    return acc, acc.prepare(DataLoader(_Dataset(n, seed=5), batch_size=4, shuffle=shuffle,
                                       seed=3))


def _epoch(acc, loader, stop=None):
    seen = []
    for i, batch in enumerate(loader):
        seen.append((batch, acc.gradient_state.end_of_dataloader, loader.state_dict()))
        if stop is not None and i + 1 == stop:
            break
    return seen


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == HostPrefetcher.THREAD_NAME]


def test_prefetching_loader_matches_the_plain_one():
    plain_acc, plain = _prepared(0)
    acc, fetched = _prepared(3)
    assert plain.prefetch_depth == 0 and fetched.prefetch_depth == 3
    for epoch in range(2):
        want, got = _epoch(plain_acc, plain), _epoch(acc, fetched)
        assert not _prefetch_threads()
        assert len(got) == len(want) == 6  # 22 rows: five of 4 and a ragged 2
        assert [g[1] for g in got] == [w[1] for w in want] == [False] * 5 + [True]
        for (gb, _, gs), (wb, _, ws) in zip(got, want):
            _equal(gb, wb)
            assert gs == ws
    # a resume from each position of an epoch, and skip_first_batches
    for pos in range(6):
        plain_acc, plain = _prepared(0)
        acc, fetched = _prepared(3)
        # the position as a checkpoint mid-epoch reads it (inside the loop)
        want = _epoch(plain_acc, plain, stop=pos)[-1][2] if pos else plain.state_dict()
        state = _epoch(acc, fetched, stop=pos)[-1][2] if pos else fetched.state_dict()
        assert state == want
        plain_acc, plain2 = _prepared(0)
        acc, fetched2 = _prepared(3)
        plain2.load_state_dict(state)
        fetched2.load_state_dict(state)
        want, got = _epoch(plain_acc, plain2), _epoch(acc, fetched2)
        assert len(got) == len(want) == 6 - pos
        for (gb, ge, gs), (wb, we, ws) in zip(got, want):
            _equal(gb, wb)
            assert (ge, gs) == (we, ws)
    acc, fetched = _prepared(3)
    skipped = _epoch(acc, acc.skip_first_batches(fetched, 2))
    assert len(skipped) == 4 and skipped[-1][1]


def test_prefetch_thread_ends_with_an_early_break():
    acc, fetched = _prepared(3, n=200)
    seen = _epoch(acc, fetched, stop=2)
    assert len(seen) == 2 and not seen[-1][1]
    assert not _prefetch_threads()
    # the next epoch starts over, from the next epoch's order
    assert len(_epoch(acc, fetched)) == 50
    assert not _prefetch_threads()
