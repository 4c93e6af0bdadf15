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
reference's batches, shuffled ones another order. Sharding across
processes and dispatch from one process belong to the multi-device slice.

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
from .utils.operations import send_to_device


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
                 prefetch_depth: int = 0):
        self.loader = loader
        self.device = device
        self.gradient_state = gradient_state
        self.skip_batches = skip_batches
        self.prefetch_depth = prefetch_depth
        self.end_of_dataloader = False
        self.iteration = 0
        self._position = 0  # batches of this pass taken, skipped ones included
        self._in_epoch = False
        self._skip_on_next_iter = 0

    def __len__(self):
        return len(self.loader)

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
                    yield _timed_send(cur, self.device)
                    return
                yield _timed_send(cur, self.device)
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


def prepare_data_loader(loader, device: torch.device,
                        gradient_state: Optional[GradientState] = None,
                        prefetch_depth: int = 0) -> DataLoaderShard:
    return DataLoaderShard(_with_seedable_sampler(loader), device, gradient_state,
                           prefetch_depth=prefetch_depth)


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
