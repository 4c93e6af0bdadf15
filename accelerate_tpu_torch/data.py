"""Data loading for training on one device, and its mid-epoch resume.

Counterpart of ``accelerate_tpu/data.py``: ``prepare_data_loader`` wraps a
torch ``DataLoader``, the port's map-style :class:`DataLoader` (or any
iterable of dicts, tuples or tensors) in a :class:`DataLoaderShard`,
which moves every batch to the accelerator's device, numpy arrays
becoming tensors, and tells the ``GradientState`` when it yields its last
batch, so an accumulation window closes at the end of an epoch.

Resume (the reference's ``state_dict`` / ``load_state_dict``, data.py:348):
a prepared loader records its epoch (``iteration``) and how many of the
epoch's batches it has handed out (``batches_yielded``); loading that
state makes the next pass start at that epoch and skip that many
batches. A shuffled loader resumes exactly when its order depends only on
``(seed, epoch)``: :class:`SeedableRandomSampler`, which the port's
:class:`DataLoader` uses and which ``prepare`` puts in place of a torch
loader's ``RandomSampler``. That order is torch's ``randperm``, not the
reference's threefry permutation: unshuffled loaders give the
reference's batches, shuffled ones another order.

Across processes (a ``mesh``, ``parallel/mesh.py``) the batch is split
over the ranks of the batch axes (``replica`` x ``data`` x ``fsdp``, the
reference's ``batch_spec``): each rank's loader reads only its own
indices (:class:`BatchSamplerShard` over a map-style dataset, with
``split_batches`` and ``even_batches``; :class:`IterableDatasetShard`
over an iterable one; round robin over ready-made batches), or, with
``dispatch_batches``, rank 0 reads each global batch and every rank takes
its slice (:class:`DataLoaderDispatcher`). The ranks of one ``stage``
group (pipeline stages) get the same rows, as every stage of a pipeline
reads the same batch; the ranks of one ``sequence`` group get the same
rows and consecutive slices of dim 1 (the reference's
``extra_sequence_axis``). Under ``even_batches`` the last global batch is
squared up from the first samples, and ``remainder`` (the real samples
in it) lets ``gather_for_metrics`` drop the repeats.

Each fetch from the wrapped loader and each move to the device is timed
into the telemetry session's data-wait bucket (``note_data_wait``, the
reference's data.py:44-56): the next step record's ``data_wait_s``.

``prefetch_depth`` > 1 (``DataLoaderConfiguration.prefetch_depth``)
wraps each pass's iterator in ``runtime/prefetch.HostPrefetcher``: a
producer thread assembles that many batches ahead into the native host
ring while the card computes (the reference's data.py:453-500). The
lookahead, the positions and the skips work on its batches as on the
loader's, and the prefetcher is closed when the pass ends or is
abandoned.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from .state import GradientState
from .telemetry import note_data_wait
from .utils.operations import (broadcast_object_list, find_batch_size, recursively_apply,
                               send_to_device)


def _timed_next(iterator):
    """Advance ``iterator``, the host's wait going to the data-wait bucket
    (a ``None`` check when no session is active)."""
    t0 = time.perf_counter()
    try:
        return next(iterator)
    finally:
        note_data_wait(time.perf_counter() - t0)


def _timed_send(batch, device: torch.device):
    """``batch`` on ``device``, copied non-blocking
    (``utils/operations.send_to_device``), timed into the same bucket:
    placement is loader work too."""
    t0 = time.perf_counter()
    try:
        return send_to_device(batch, device, non_blocking=True)
    finally:
        note_data_wait(time.perf_counter() - t0)


def default_collate(samples: list):
    """Stack samples into a batch: dicts and tuples by field, tensors with
    ``torch.stack``, anything else as a numpy array (the reference's)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(samples)
    return np.asarray(samples)


class SeedableRandomSampler(torch.utils.data.Sampler):
    """The indices of a dataset of ``data_source_len`` items in an order
    that depends only on ``(seed, epoch)``: ``torch.randperm`` from a
    generator seeded ``seed + epoch``, upstream Accelerate's rule. Each
    pass advances the epoch; ``set_epoch`` sets it."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        super().__init__()
        self.data_source_len = int(data_source_len)
        self.seed = int(seed)
        self.epoch = int(epoch)

    def __len__(self):
        return self.data_source_len

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __iter__(self):
        gen = torch.Generator().manual_seed(self.seed + self.epoch)
        order = torch.randperm(self.data_source_len, generator=gen).tolist()
        self.epoch += 1
        yield from order

    def state_dict(self) -> dict:
        return {"seed": self.seed, "epoch": self.epoch}

    def load_state_dict(self, state: dict):
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])


class DataLoader:
    """Map-style loader (the reference's ``DataLoader``, data.py:947): a
    dataset with ``__getitem__`` / ``__len__``, cut into batches of
    ``batch_size`` in index order or, with ``shuffle``, in a
    :class:`SeedableRandomSampler`'s order from ``seed``; ``collate_fn``
    (default :func:`default_collate`) makes each batch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.seed = seed
        self.sampler = (SeedableRandomSampler(len(dataset), seed=seed) if shuffle
                        else range(len(dataset)))

    def __iter__(self):
        indices = []
        for i in self.sampler:
            indices.append(int(i))
            if len(indices) == self.batch_size:
                yield self.collate_fn([self.dataset[j] for j in indices])
                indices = []
        if indices and not self.drop_last:
            yield self.collate_fn([self.dataset[j] for j in indices])

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class DataLoaderShard:
    """Iterates the wrapped loader with one batch of lookahead, so
    ``end_of_dataloader`` is True while the last batch is in use. Each
    pass sets the epoch (``iteration``) on the loader's sampler, skips
    ``skip_batches`` batches (and, once, the position a loaded state
    names) and advances ``iteration`` when it ends."""

    def __init__(self, loader, device: torch.device,
                 gradient_state: Optional[GradientState] = None, skip_batches: int = 0,
                 prefetch_depth: int = 0, batch_size: Optional[int] = None,
                 num_shards: int = 1, even_batches: bool = True, sequence: tuple = (0, 1)):
        self.loader = loader
        self.device = device
        self.gradient_state = gradient_state
        self.skip_batches = skip_batches
        self.prefetch_depth = prefetch_depth
        self.batch_size = batch_size  # per batch shard
        self.num_shards = num_shards  # ranks of the batch axes
        self.even_batches = even_batches  # the last global batch is squared up
        self.sequence = sequence  # (this rank's chunk, chunks) of dim 1
        self.remainder = -1
        self.end_of_dataloader = False
        self.iteration = 0
        self._position = 0  # batches of this pass taken, skipped ones included
        self._in_epoch = False
        self._skip_on_next_iter = 0

    def __len__(self):
        return len(self.loader)

    @property
    def total_batch_size(self) -> Optional[int]:
        return None if self.batch_size is None else self.batch_size * self.num_shards

    def _remainder(self) -> int:
        """The real samples of the last global batch when ``even_batches``
        squares it up from the first ones, else -1."""
        ds = getattr(self.loader, "dataset", None)
        gbs = self.total_batch_size
        if not (self.even_batches and gbs and ds is not None and hasattr(ds, "__len__")):
            return -1
        return len(ds) % gbs or -1

    def _place(self, batch):
        """``batch`` on the device, dim 1 cut to this rank's chunk on a
        ``sequence`` axis."""
        chunk, n = self.sequence
        if n > 1:
            def cut(t):
                if t.ndim < 2:
                    return t
                if t.shape[1] % n:
                    raise ValueError(f"a batch leaf's dim 1 ({t.shape[1]}) does not divide "
                                     f"over {n} sequence ranks")
                w = t.shape[1] // n
                return t[:, chunk * w:(chunk + 1) * w]

            batch = recursively_apply(cut, batch)
        return _timed_send(batch, self.device)

    def set_epoch(self, epoch: int):
        """Set ``iteration`` and the epoch of every part of the loader that
        has a ``set_epoch`` (its sampler, batch sampler or dataset)."""
        self.iteration = epoch
        loader = self.loader
        parts = (loader, getattr(loader, "dataset", None), getattr(loader, "sampler", None),
                 getattr(loader, "batch_sampler", None),
                 getattr(getattr(loader, "batch_sampler", None), "sampler", None))
        seen = set()
        for obj in parts:
            if obj is not None and id(obj) not in seen and hasattr(obj, "set_epoch"):
                seen.add(id(obj))
                obj.set_epoch(epoch)

    def state_dict(self) -> dict:
        """``{"batches_yielded", "iteration"}``, the reference's keys: the
        position in the current epoch, or the next epoch's start once the
        epoch's last batch is out."""
        if self.end_of_dataloader and self._in_epoch:
            return {"batches_yielded": 0, "iteration": self.iteration + 1}
        return {"batches_yielded": self._position, "iteration": self.iteration}

    def load_state_dict(self, state: dict):
        """The next pass runs epoch ``iteration`` from batch
        ``batches_yielded``."""
        self._skip_on_next_iter = int(state.get("batches_yielded", 0))
        if "iteration" in state:
            self.iteration = int(state["iteration"])

    def __iter__(self):
        if self.gradient_state is not None:
            self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        skip = self.skip_batches + self._skip_on_next_iter
        self._skip_on_next_iter = 0
        self.set_epoch(self.iteration)
        self._position = 0
        self._in_epoch = True
        self.remainder = self._remainder()
        prefetcher = None
        try:
            it = iter(self.loader)
            if self.prefetch_depth > 1:
                from .runtime.prefetch import HostPrefetcher

                prefetcher = HostPrefetcher(it, depth=self.prefetch_depth)
                it = iter(prefetcher)
            for _ in range(skip):
                try:
                    next(it)
                except StopIteration:
                    return
                self._position += 1
            try:
                nxt = _timed_next(it)
            except StopIteration:
                return
            while True:
                cur = nxt
                self._position += 1
                try:
                    nxt = _timed_next(it)
                except StopIteration:
                    self.end_of_dataloader = True
                    yield self._place(cur)
                    return
                yield self._place(cur)
        finally:
            if prefetcher is not None:
                # wakes and ends the producer thread, also when the
                # consumer leaves the epoch early
                prefetcher.close()
            self._in_epoch = False
            self._position = 0
            self.iteration += 1
            if self.gradient_state is not None:
                self.gradient_state._remove_dataloader(self)


def _with_seedable_sampler(loader):
    """A torch ``DataLoader`` that shuffles with a plain ``RandomSampler``
    rebuilt over a :class:`SeedableRandomSampler`, so its order depends
    only on (seed, epoch) and a resumed epoch replays it. The seed is the
    sampler's (or the loader's) generator's initial seed, else torch's
    (``set_seed``). Any other loader is returned as it is."""
    from torch.utils.data import DataLoader as TorchDataLoader
    from torch.utils.data import RandomSampler

    if not (isinstance(loader, TorchDataLoader) and type(loader.sampler) is RandomSampler
            and loader.batch_size is not None and not loader.sampler.replacement
            and loader.sampler._num_samples is None):
        return loader
    gen = loader.sampler.generator or loader.generator
    seed = gen.initial_seed() if gen is not None else torch.initial_seed()
    kw = {}
    if loader.num_workers > 0:
        kw = {"prefetch_factor": loader.prefetch_factor,
              "persistent_workers": loader.persistent_workers}
    return TorchDataLoader(
        loader.dataset, batch_size=loader.batch_size,
        sampler=SeedableRandomSampler(len(loader.dataset), seed=seed),
        num_workers=loader.num_workers, collate_fn=loader.collate_fn,
        pin_memory=loader.pin_memory, drop_last=loader.drop_last, timeout=loader.timeout,
        worker_init_fn=loader.worker_init_fn, generator=loader.generator, **kw)


class BatchSamplerShard:
    """This process's batches of an iterable of index batches (the
    reference's, data.py:94). ``split_batches``: each global batch is cut
    into ``num_processes`` contiguous parts (the batch size must divide);
    else whole batches go round robin (process i takes batches i, i + N,
    ...). ``even_batches`` gives every process the same number of full
    batches by wrapping around to the first samples."""

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        if split_batches and hasattr(batch_sampler, "batch_size") \
                and batch_sampler.batch_size % num_processes:
            raise ValueError(
                f"To use `BatchSamplerShard` in `split_batches` mode, the batch size "
                f"({batch_sampler.batch_size}) needs to be a round multiple of the number "
                f"of processes ({num_processes}).")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)
        if self.batch_size is None and self.even_batches:
            raise ValueError(
                "You need to use `even_batches=False` when the batch sampler has no batch size.")

    def __len__(self):
        if self.split_batches:
            return len(self.batch_sampler)
        n, k = len(self.batch_sampler), self.num_processes
        if n % k == 0 or self.drop_last:
            return n // k
        if self.even_batches:
            return n // k + 1
        return n // k + (1 if self.process_index < n % k else 0)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int):
        for obj in (self.batch_sampler, getattr(self.batch_sampler, "sampler", None)):
            if obj is not None and hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)

    def __iter__(self):
        return self._iter_with_split() if self.split_batches else self._iter_with_no_split()

    def _iter_with_split(self):
        # each full global batch gives this process's window [lo:hi]; a
        # ragged last batch is sliced as it is or squared up from the head
        per_proc = self.batch_size // self.num_processes
        lo, hi = per_proc * self.process_index, per_proc * (self.process_index + 1)
        head, tail = [], []
        for raw in self.batch_sampler:
            batch = list(raw)
            if not head:
                head = batch
            if len(batch) == self.batch_size:
                yield batch[lo:hi]
                tail = []
            else:
                tail = batch
        if self.drop_last or not tail:
            return
        if not self.even_batches:
            if len(tail) > lo:
                yield tail[lo:hi]
            return
        while len(tail) < self.batch_size:
            tail = tail + head
        yield tail[lo:hi]

    def _iter_with_no_split(self):
        # rounds of num_processes whole batches, process i taking slot i;
        # the unfinished last round is squared up from the first round's
        # samples so every process ends with as many full batches
        pool, round_ = [], []
        for count, raw in enumerate(self.batch_sampler):
            batch = list(raw)
            if not self.drop_last and count < self.num_processes:
                pool.extend(batch)
            round_.append(batch)
            del round_[: -(count % self.num_processes) - 1]
            if len(round_) == self.num_processes and (
                    self.batch_size is None or len(batch) == self.batch_size):
                yield round_[self.process_index]
                round_ = []
        if self.drop_last or not pool or not round_:
            return
        if not self.even_batches:
            if self.process_index < len(round_):
                yield round_[self.process_index]
            return
        while len(pool) < self.num_processes * self.batch_size:
            pool = pool + pool
        cursor = 0
        if len(round_[-1]) < self.batch_size:
            need = self.batch_size - len(round_[-1])
            round_[-1] = round_[-1] + pool[:need]
            cursor = need
        while len(round_) < self.num_processes:
            round_.append(pool[cursor:cursor + self.batch_size])
            cursor += self.batch_size
        yield round_[self.process_index]


class SimpleBatchSampler:
    """Index batches of ``batch_size`` over a sampler of indices."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class IterableDatasetShard:
    """This process's items of an iterable dataset (the reference's,
    data.py:251): windows of ``batch_size * num_processes`` items (of
    ``batch_size`` with ``split_batches``), this process's contiguous part
    of each; a short last window wraps around to the first one's items
    under ``even_batches``."""

    def __init__(self, dataset, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False,
                 even_batches: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self):
        window = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        per_proc = window // self.num_processes
        lo, hi = per_proc * self.process_index, per_proc * (self.process_index + 1)
        head, buf = None, []
        for item in self.dataset:
            buf.append(item)
            if len(buf) == window:
                yield from buf[lo:hi]
                if head is None:
                    head = list(buf)
                buf = []
        if self.drop_last or not buf:
            return
        if not self.even_batches:
            yield from buf[lo:hi]
            return
        pad = head if head is not None else list(buf)
        while len(buf) < window:
            buf = buf + pad
        yield from buf[lo:hi]


class _MapLoader:
    """A map-style dataset read through a (sharded) batch sampler."""

    def __init__(self, dataset, batch_sampler, collate_fn=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate

    def __iter__(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def __len__(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch):
        for obj in (self.dataset, self.batch_sampler):
            if hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)


class _ItemLoader:
    """Items of an iterable (an :class:`IterableDatasetShard`) collated
    into batches of ``batch_size``."""

    def __init__(self, items, batch_size: int, collate_fn=None):
        self.dataset = items
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate

    def __iter__(self):
        buf = []
        for item in self.dataset:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf:
            yield self.collate_fn(buf)

    def set_epoch(self, epoch):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)


class _RoundRobinLoader:
    """Ready-made batches, process i taking batches i, i + N, ..."""

    def __init__(self, iterable, num_processes: int, process_index: int):
        self.iterable = iterable
        self.num_processes = num_processes
        self.process_index = process_index

    def __iter__(self):
        for i, batch in enumerate(self.iterable):
            if i % self.num_processes == self.process_index:
                yield batch

    def __len__(self):
        n = len(self.iterable)
        return n // self.num_processes + (1 if n % self.num_processes > self.process_index else 0)

    def set_epoch(self, epoch):
        if hasattr(self.iterable, "set_epoch"):
            self.iterable.set_epoch(epoch)


def _shard_loader(loader, num_processes: int, process_index: int, split_batches: bool,
                  even_batches: bool):
    """(a loader of this process's batches only, its per-process batch
    size or None): the reference's ``_shard_loader``. A torch
    ``DataLoader`` and the port's :class:`DataLoader` are rebuilt over a
    :class:`BatchSamplerShard` (a shuffled one over a
    :class:`SeedableRandomSampler`, as :func:`_with_seedable_sampler`
    makes it), an iterable torch dataset over an
    :class:`IterableDatasetShard`; any other iterable of batches goes
    round robin."""
    from torch.utils.data import DataLoader as TorchDataLoader

    if isinstance(loader, TorchDataLoader):
        if loader.batch_sampler is None:  # an iterable-style dataset
            shard = IterableDatasetShard(
                loader.dataset, batch_size=loader.batch_size, drop_last=loader.drop_last,
                num_processes=num_processes, process_index=process_index,
                split_batches=split_batches, even_batches=even_batches)
            per = loader.batch_size // num_processes if split_batches else loader.batch_size
            return _ItemLoader(shard, per, loader.collate_fn), per
        loader = _with_seedable_sampler(loader)
        bs = loader.batch_sampler
        base = SimpleBatchSampler(bs.sampler, bs.batch_size, bs.drop_last)
        sharded = BatchSamplerShard(base, num_processes, process_index, split_batches,
                                    even_batches)
        per = bs.batch_size // num_processes if split_batches else bs.batch_size
        return _MapLoader(loader.dataset, sharded, loader.collate_fn), per
    if isinstance(loader, DataLoader):
        base = SimpleBatchSampler(loader.sampler, loader.batch_size, loader.drop_last)
        sharded = BatchSamplerShard(base, num_processes, process_index, split_batches,
                                    even_batches)
        per = loader.batch_size // num_processes if split_batches else loader.batch_size
        return _MapLoader(loader.dataset, sharded, loader.collate_fn), per
    return _RoundRobinLoader(loader, num_processes, process_index), None


class DataLoaderDispatcher(DataLoaderShard):
    """Rank 0 reads each global batch and broadcasts it; every rank keeps
    its contiguous slice of dim 0 (the reference's, data.py:517 and its
    ``_scatter_from_main``). A short last global batch is squared up by
    repeating its first rows (``remainder``: the real ones), or, without
    ``even_batches``, raises. For sources whose order cannot be replayed
    on every rank; the sharded :class:`DataLoaderShard` moves no batch
    between ranks."""

    def __init__(self, loader, device, gradient_state=None, *, batch_size=None,
                 num_shards: int = 1, shard_index: int = 0, even_batches: bool = True,
                 sequence: tuple = (0, 1), prefetch_depth: int = 0):
        super().__init__(loader, device, gradient_state, batch_size=batch_size,
                         num_shards=num_shards, even_batches=even_batches,
                         sequence=sequence, prefetch_depth=prefetch_depth)
        self.shard_index = shard_index

    def _remainder(self) -> int:
        return -1  # set by each batch as it is read

    def __iter__(self):
        from .state import PartialState

        main = PartialState().is_main_process
        shard = self._dispatched(iter(self.loader) if main else None, main)
        inner, self.loader = self.loader, _Replay(shard, self.loader)
        try:
            yield from super().__iter__()
        finally:
            self.loader = inner

    def _dispatched(self, it, main: bool):
        while True:
            info = [None, None, None]
            if main:
                try:
                    batch = next(it)
                    batch, real = self._square(batch)
                    info = [batch, real, None]
                except StopIteration:
                    pass
                except Exception as e:  # every rank raises together
                    info = [None, None, f"{type(e).__name__}: {e}"]
            info = broadcast_object_list(info)
            if info[2] is not None:
                raise RuntimeError(f"the main process's loader failed: {info[2]}")
            if info[0] is None:
                return
            if info[1] is not None:
                self.remainder = info[1]
            yield self._slice(info[0])

    def _square(self, batch):
        rows = find_batch_size(batch)
        if rows is None:
            return batch, None
        target = (self.batch_size * self.num_shards if self.batch_size is not None
                  else -(-rows // self.num_shards) * self.num_shards)
        if rows >= target:
            return batch, None
        if not self.even_batches:
            raise ValueError(
                f"dispatch_batches with even_batches=False cannot shard a ragged final "
                f"batch of {rows} rows across {self.num_shards} processes; use "
                "drop_last=True or keep even_batches=True")

        def pad(t):
            if t.ndim == 0 or t.shape[0] != rows:
                return t
            reps, missing = [t], target - rows
            while missing > 0:
                take = min(missing, rows)
                reps.append(t[:take])
                missing -= take
            return torch.cat(reps) if isinstance(t, torch.Tensor) else np.concatenate(reps)

        return recursively_apply(pad, batch), rows

    def _slice(self, batch):
        rows = find_batch_size(batch)
        if rows is None:
            return batch
        if rows % self.num_shards:
            raise ValueError(f"dispatch_batches requires the global batch dimension ({rows}) "
                             f"to divide evenly across {self.num_shards} processes")
        per = rows // self.num_shards
        lo = self.shard_index * per
        return recursively_apply(lambda t: t if t.ndim == 0 else t[lo:lo + per], batch)


class _Replay:
    """An iterable over one pass of ``batches`` with the wrapped loader's
    length and dataset (what the shard's bookkeeping reads)."""

    def __init__(self, batches, loader):
        self.batches = batches
        self.dataset = getattr(loader, "dataset", None)
        self._len = loader

    def __iter__(self):
        return self.batches

    def __len__(self):
        return len(self._len)


class _GlobalRebatch:
    """N consecutive batches of a loader concatenated into one global
    batch (dispatch from a loader of per-process batches)."""

    def __init__(self, base, n: int):
        self.base = base
        self.n = int(n)
        self.dataset = getattr(base, "dataset", None)

    def __iter__(self):
        chunk = []
        for batch in self.base:
            chunk.append(batch)
            if len(chunk) == self.n:
                yield _concat(chunk)
                chunk = []
        if chunk:
            yield _concat(chunk)

    def __len__(self):
        return -(-len(self.base) // self.n)


def _concat(batches: list):
    from .utils.operations import concatenate

    return batches[0] if len(batches) == 1 else concatenate(batches)


def prepare_data_loader(loader, device: torch.device,
                        gradient_state: Optional[GradientState] = None,
                        prefetch_depth: int = 0, mesh=None, config=None):
    """``loader`` wrapped for this process: a :class:`DataLoaderShard` of
    the process's shard of every global batch over the mesh's batch axes
    (a :class:`DataLoaderDispatcher` with ``config.dispatch_batches``),
    dim 1 cut to its chunk on a ``sequence`` axis; on one process, the
    loader's own batches. ``config`` is the ``DataLoaderConfiguration``
    (``split_batches``, ``dispatch_batches``, ``even_batches``)."""
    from .parallel.mesh import axis_index

    index, count = axis_index(mesh, ("replica", "data", "fsdp"))
    sequence = axis_index(mesh, ("sequence",))
    split = bool(config.split_batches) if config is not None else False
    even = bool(config.even_batches) if config is not None else True
    if config is not None and config.dispatch_batches and (count > 1 or sequence[1] > 1):
        bs = getattr(loader, "batch_size", None)
        per = None if bs is None else (bs // count if split else bs)
        base = loader if split or count == 1 else _GlobalRebatch(loader, count)
        return DataLoaderDispatcher(base, device, gradient_state, batch_size=per,
                                    num_shards=count, shard_index=index, even_batches=even,
                                    sequence=sequence, prefetch_depth=prefetch_depth)
    if count == 1:  # one batch shard pads nothing
        return DataLoaderShard(_with_seedable_sampler(loader), device, gradient_state,
                               prefetch_depth=prefetch_depth, even_batches=False,
                               sequence=sequence)
    base, per = _shard_loader(loader, count, index, split, even)
    # the last global batch is squared up only from a loader that keeps its
    # short tail, and never for ready-made batches (round robin)
    pads = even and per is not None and not getattr(loader, "drop_last", False)
    return DataLoaderShard(base, device, gradient_state, prefetch_depth=prefetch_depth,
                           batch_size=per, num_shards=count, even_batches=pads,
                           sequence=sequence)


class _SkipBatches:
    """An iterable without its first ``num_batches`` batches."""

    def __init__(self, inner, num_batches: int):
        self.inner = inner
        self.num_batches = num_batches
        self.dataset = getattr(inner, "dataset", None)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i >= self.num_batches:
                yield batch

    def __len__(self):
        return max(0, len(self.inner) - self.num_batches)


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader that skips the first ``num_batches`` batches of every pass
    (the reference's, data.py:987): a copy of a prepared loader with more
    ``skip_batches``, or a wrapper around any other iterable. Resume the
    epoch with it, then go on with the original loader."""
    if isinstance(dataloader, DataLoaderShard):
        new = copy.copy(dataloader)
        new.skip_batches = dataloader.skip_batches + num_batches
        return new
    return _SkipBatches(dataloader, num_batches)
