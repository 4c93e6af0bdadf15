"""Device maps and the checkpoint load path of big-model inference.

Counterpart of ``accelerate_tpu/utils/modeling.py``. Weights are placed
on three tiers:

  "device"  the card's memory
  "cpu"     pinned host memory, streamed to the card per layer at use
  "disk"    a numpy-memmap folder (``utils/offload.py``), made pinned once
            per call and then streamed like "cpu"

:func:`infer_auto_device_map` is the reference's greedy first fit of
module groups (top-level path prefixes of the flat tree) into those
tiers, splitting a group that overflows into its children: the same tree
under the same budgets gives the same map. A stacked ``layers`` group
therefore splits by leaf kind across all layers
(``layers/block/attn/wq``, ..., ``layers/block/mlp/w_up``), not by layer.

:func:`load_checkpoint_in_model` routes each checkpoint leaf to its tier
as it is read: device-tier leaves through a read -> quantize -> submit
pipeline (:func:`_stream_device_leaves`), host-tier leaves into pinned
memory, disk-tier leaves into the offload folder.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .serialization import flatten_pytree, load_flat_dict, unflatten_to_like

# the reference's budget of a CPU device (its table of device memory by
# kind), so the port's maps on the CPU equal the reference's there
CPU_DEVICE_BYTES = 8 << 30


def dtype_byte_size(dtype: torch.dtype) -> float:
    """Bytes per element (bool counts 1/8, as the reference does)."""
    if dtype == torch.bool:
        return 1.0 / 8
    return dtype.itemsize


def compute_module_sizes(params, dtype: Optional[torch.dtype] = None) -> dict[str, int]:
    """Bytes per path prefix, every ancestor counted (``sizes[""]`` is the
    total). Leaves may be tensors or meta tensors; ``dtype`` overrides
    every leaf's."""
    sizes: dict[str, int] = {}
    for path, leaf in flatten_pytree(params).items():
        size = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
        nbytes = int(size * dtype_byte_size(dtype or leaf.dtype))
        parts = path.split("/")
        for i in range(len(parts) + 1):
            prefix = "/".join(parts[:i])
            sizes[prefix] = sizes.get(prefix, 0) + nbytes
    return sizes


def get_max_memory(max_memory: Optional[dict] = None, device=None) -> dict[str, int]:
    """Tier budgets: ``{"device": 0.9 of the card's free memory, "cpu": 0.9
    of the host's, "disk": unbounded}`` (the reference's 0.9 headroom). A
    CPU ``device`` gets the reference's CPU budget, 8 GiB. ``device`` None
    means CUDA and raises without it."""
    from ..models.decoder import resolve_device

    if max_memory is not None:
        return dict(max_memory)
    dev = resolve_device(device)
    if dev.type == "cuda":
        device_bytes = torch.cuda.mem_get_info(dev)[0]
    else:
        device_bytes = CPU_DEVICE_BYTES
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return {"device": int(device_bytes * 0.9), "cpu": int(host * 0.9), "disk": 1 << 62}


def find_tied_parameters(params) -> list[list[str]]:
    """Groups of paths holding the same tensor object."""
    by_id: dict[int, list[str]] = {}
    for path, leaf in flatten_pytree(params).items():
        by_id.setdefault(id(leaf), []).append(path)
    return [paths for paths in by_id.values() if len(paths) > 1]


def _module_groups(params) -> list[str]:
    """Placement units: the unique top-level path components, in tree
    order (a stacked layer tree is one group)."""
    groups, seen = [], set()
    for path in flatten_pytree(params):
        prefix = path.split("/")[0]
        if prefix not in seen:
            seen.add(prefix)
            groups.append(prefix)
    return groups


def get_balanced_memory(params, max_memory: Optional[dict] = None, dtype=None,
                        low_zero: bool = False, device=None) -> dict[str, int]:
    """Budgets with activation headroom on the device tier: less half the
    largest top-level group, or (``low_zero``, the reference's
    balanced_low_0) half the device budget."""
    budgets = get_max_memory(max_memory, device)
    sizes = compute_module_sizes(params, dtype=dtype)
    groups = [sizes.get(g, 0) for g in _module_groups(params)]
    largest = max(groups) if groups else 0
    out = dict(budgets)
    if low_zero:
        out["device"] = int(budgets["device"] * 0.5)
    else:
        out["device"] = int(budgets["device"]) - largest // 2
    return out


def _child_groups(all_paths: list[str], prefix: str) -> list[str]:
    """Next-depth prefixes strictly under ``prefix``."""
    depth = len(prefix.split("/")) if prefix else 0
    children, seen = [], set()
    for path in all_paths:
        if prefix and not (path == prefix or path.startswith(prefix + "/")):
            continue
        parts = path.split("/")
        if len(parts) <= depth:
            continue
        child = "/".join(parts[: depth + 1])
        if child not in seen:
            seen.add(child)
            children.append(child)
    return children


def infer_auto_device_map(params, max_memory: Optional[dict] = None, dtype=None,
                          mode: str = "auto", device=None) -> dict[str, str]:
    """Fit module groups into device -> cpu -> disk in tree order.

    - The tier only advances: once a group spills to "cpu", later groups
      never go back to "device".
    - A group that overflows the current tier splits into its children
      (through single-child chains) and they are fitted in its place,
      down to single leaves.
    - Tied leaves ride with their first-placed partner at no cost.
    - ``mode``: "auto" / "balanced" keep headroom on the device, and
      "balanced_low_0" halves its budget (:func:`get_balanced_memory`);
      "sequential" uses the raw budgets.
    """
    if mode in ("auto", "balanced"):
        budgets = get_balanced_memory(params, max_memory, dtype=dtype, device=device)
    elif mode == "balanced_low_0":
        budgets = get_balanced_memory(params, max_memory, dtype=dtype, low_zero=True,
                                      device=device)
    elif mode == "sequential":
        budgets = get_max_memory(max_memory, device)
    else:
        raise ValueError(f"unknown device-map mode {mode!r}")

    all_paths = list(flatten_pytree(params))
    sizes = compute_module_sizes(params, dtype=dtype)
    tie_leader: dict[str, str] = {}
    for group in find_tied_parameters(params):
        for path in group[1:]:
            tie_leader[path] = group[0]

    def leaves_of(prefix: str) -> list[str]:
        return [p for p in all_paths if p == prefix or p.startswith(prefix + "/")]

    device_map: dict[str, str] = {}
    placed_leaves: dict[str, str] = {}
    remaining = {k: int(v) for k, v in budgets.items()}
    tiers = [t for t in ("device", "cpu", "disk") if t in remaining]
    worklist = deque(_module_groups(params))
    cur = 0
    while worklist:
        group = worklist.popleft()
        leaves = leaves_of(group)
        free_riders = [p for p in leaves if tie_leader.get(p) in placed_leaves]
        size = sizes.get(group, 0) - sum(sizes.get(p, 0) for p in free_riders)
        if size <= 0 and free_riders:
            tier = placed_leaves[tie_leader[free_riders[0]]]
            device_map[group] = tier
            for p in leaves:
                placed_leaves[p] = tier
            continue
        placed = False
        while cur < len(tiers):
            tier = tiers[cur]
            if size <= remaining[tier]:
                device_map[group] = tier
                remaining[tier] -= size
                for p in leaves:
                    placed_leaves[p] = tier
                placed = True
                break
            children = _child_groups(all_paths, group)
            while len(children) == 1:
                children = _child_groups(all_paths, children[0])
            if len(children) > 1 and remaining[tier] > 0:
                worklist.extendleft(reversed(children))
                placed = True
                break
            cur += 1
        if not placed:
            raise ValueError(f"module group {group!r} ({size} bytes) does not fit "
                             f"any memory tier {remaining}")
    for path, leader in tie_leader.items():
        if leader in placed_leaves and placed_leaves.get(path) != placed_leaves[leader]:
            device_map[path] = placed_leaves[leader]
    return device_map


def check_device_map(params, device_map: Mapping[str, str]) -> None:
    """Raise unless every leaf is covered by a prefix of ``device_map``."""
    uncovered = [path for path in flatten_pytree(params)
                 if not any(p == "" or path == p or path.startswith(p + "/")
                            for p in device_map)]
    if uncovered:
        raise ValueError(f"device_map does not cover: {uncovered[:5]}"
                         f"{'...' if len(uncovered) > 5 else ''}")


def placement_of(path: str, device_map: Mapping[str, str]) -> str:
    """Longest-prefix lookup of a leaf's tier ("device" when none covers it)."""
    best, best_len = "device", -1
    for prefix, tier in device_map.items():
        if prefix == "" or path == prefix or path.startswith(prefix + "/"):
            if len(prefix) > best_len:
                best, best_len = tier, len(prefix)
    return best


# ---------------------------------------------------------------------------
# the load path
# ---------------------------------------------------------------------------


class PhaseSeconds(dict):
    """Seconds per load phase (``ckpt_read``, ``host_quantize``,
    ``transfer_submit``, ``weight_stream_total``), each summed over the
    threads that run it: the pipeline's stages overlap, so their sum can
    exceed the wall, and the gap is the overlap."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self[name] = self.get(name, 0.0) + dt


def _cast(value: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The checkpoint tensor with a floating ``dtype`` override applied,
    lifted into memory (a view of the mapped file is copied)."""
    if dtype is not None and value.dtype.is_floating_point and value.dtype != dtype:
        return value.to(dtype)
    return value.clone()


def load_checkpoint_in_model(abstract_params, checkpoint: str,
                             device_map: Optional[Mapping[str, str]] = None,
                             offload_folder: Optional[str] = None,
                             dtype: Optional[torch.dtype] = None,
                             quantization_config=None, device=None,
                             phases: Optional[PhaseSeconds] = None):
    """Read ``checkpoint`` (anything :func:`load_flat_dict` reads) into the
    structure of ``abstract_params``, each leaf on its tier: device-tier
    leaves on ``device`` (quantized on the host first when
    ``quantization_config`` makes them eligible), "cpu" leaves in pinned
    host memory (plain host memory for a CPU ``device``: there is nothing
    to pin), "disk" leaves written to ``offload_folder`` and held as
    :class:`_DiskWeight` handles. ``dtype`` casts floating leaves.
    ``phases`` collects the stages' seconds."""
    from ..models.decoder import resolve_device
    from .offload import offload_state_dict

    dev = resolve_device(device)
    phases = phases if phases is not None else PhaseSeconds()
    device_map = dict(device_map or {"": "device"})
    flat_abstract = flatten_pytree(abstract_params)
    flat_loaded = load_flat_dict(checkpoint)
    missing = [k for k in flat_abstract if k not in flat_loaded]
    if missing:
        raise ValueError(f"checkpoint {checkpoint} is missing weights: {missing[:5]}")
    if any(placement_of(p, device_map) == "disk" for p in flat_abstract) and offload_folder is None:
        raise ValueError("device_map places weights on disk but no offload_folder given")

    out: dict[str, Any] = {}
    disk_dict = {}
    device_paths = []
    for path in flat_abstract:
        tier = placement_of(path, device_map)
        if tier == "device":
            device_paths.append(path)
            continue
        with phases("ckpt_read"):
            value = _cast(flat_loaded[path], dtype)
        if tier == "cpu":
            out[path] = _to_pinned_host(value, dev)
        else:
            name = path.replace("/", ".")
            disk_dict[name] = value
            out[path] = _DiskWeight(name, offload_folder, tuple(value.shape), value.dtype)
    out.update(_stream_device_leaves(device_paths, flat_loaded, dev, dtype,
                                     quantization_config, phases))
    if disk_dict:
        offload_state_dict(offload_folder, disk_dict)
    return unflatten_to_like(out, abstract_params)


# one host -> device submit copies at most this many bytes, through one of
# two pinned staging buffers that alternate
_CHUNK_BYTES = 64 << 20
# bytes read off the checkpoint and not yet submitted (never blocks an
# empty pipeline, so a larger leaf still flows, alone)
_READAHEAD_BYTES = 256 << 20


class _ByteGate:
    """Byte-budget backpressure between the reader and the submitter: the
    reader blocks while ``outstanding + n`` would exceed the budget, unless
    nothing is outstanding."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.outstanding = 0
        self._cv = threading.Condition()

    def acquire(self, n: int):
        with self._cv:
            while self.outstanding > 0 and self.outstanding + n > self.limit:
                self._cv.wait()
            self.outstanding += n

    def release(self, n: int):
        with self._cv:
            self.outstanding -= n
            self._cv.notify_all()


class _Submitter:
    """Host -> device copies through two pinned 64 MB staging buffers: a
    piece of a leaf is copied into a free buffer, then to the card with a
    ``non_blocking`` copy, and an event marks when the buffer is free
    again, so the host fills one buffer while the card drains the other.
    On a CPU device a leaf is kept as it is."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stage = [torch.empty(_CHUNK_BYTES, dtype=torch.uint8, pin_memory=True)
                          for _ in range(2)]
            self.events = [None, None]
            self.turn = 0

    def submit(self, value: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return value
        out = torch.empty(value.shape, dtype=value.dtype, device=self.device)
        src = value.reshape(-1).view(torch.uint8)
        dst = out.reshape(-1).view(torch.uint8)
        for start in range(0, src.numel(), _CHUNK_BYTES):
            n = min(_CHUNK_BYTES, src.numel() - start)
            k = self.turn
            self.turn ^= 1
            if self.events[k] is not None:
                self.events[k].synchronize()
            self.stage[k][:n].copy_(src[start:start + n])
            dst[start:start + n].copy_(self.stage[k][:n], non_blocking=True)
            self.events[k] = torch.cuda.Event()
            self.events[k].record()
        return out

    def finish(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


def _stream_device_leaves(device_paths, flat_loaded, device: torch.device, dtype,
                          quantization_config, phases: PhaseSeconds) -> dict:
    """Device-tier leaves through three overlapping stages:

      reader thread    materializes each leaf off the checkpoint (page-in,
                       dtype cast), under the read-ahead byte gate
      quantize pool    ``min(4, cores)`` workers pack eligible leaves with
                       the native helper (the ctypes call releases the
                       interpreter lock; one native call at a time, on
                       every core) or the plain version; one worker when
                       nothing quantizes. Results carry the reader's
                       sequence number and are submitted in that order
      caller thread    submits each leaf (each packed tensor) to the card
                       through :class:`_Submitter`

    Each stage times itself under its phase name. Returns ``{path:
    tensor or QuantizedWeight}`` on ``device``."""
    from .quantization import _eligible, quantize_array_host

    out: dict[str, Any] = {}
    submitter = _Submitter(device)
    gate = _ByteGate(_READAHEAD_BYTES)

    def read_one(path):
        with phases("ckpt_read"):
            return _cast(flat_loaded[path], dtype)

    def quantize_one(path, value):
        if quantization_config is not None and _eligible(path, value, quantization_config):
            with phases("host_quantize"):
                return quantize_array_host(
                    value, bits=quantization_config.bits,
                    group_size=quantization_config.group_size,
                    qtype=quantization_config.quant_type,
                    double_quant=quantization_config.double_quant)
        return value

    def submit_one(path, value, gate_bytes):
        gate.release(gate_bytes)
        with phases("transfer_submit"):
            if isinstance(value, torch.Tensor):
                out[path] = submitter.submit(value)
            else:  # a QuantizedWeight: each packed tensor
                children = flatten_pytree(value)
                placed = {k: submitter.submit(v) for k, v in children.items()}
                out[path] = unflatten_to_like(placed, value)

    def leaf_nbytes(path):
        leaf = flat_loaded[path]
        itemsize = leaf.dtype.itemsize
        if dtype is not None and leaf.dtype.is_floating_point:
            itemsize = max(itemsize, dtype.itemsize)
        return leaf.numel() * itemsize

    n_quant = min(4, os.cpu_count() or 1) if quantization_config is not None else 1
    q_read: queue.Queue = queue.Queue(maxsize=4)
    q_done: queue.Queue = queue.Queue(maxsize=4)
    errors: list = []
    stop = threading.Event()

    def put(q, item) -> bool:
        """A bounded put that gives up once the pipeline stops."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for seq, path in enumerate(device_paths):
                nbytes = leaf_nbytes(path)
                gate.acquire(nbytes)
                if stop.is_set() or not put(q_read, (seq, path, read_one(path), nbytes)):
                    gate.release(nbytes)
                    return
        except BaseException as e:  # re-raised on the caller's thread
            errors.append(e)
        finally:
            put(q_read, None)

    def quantizer():
        try:
            while True:
                item = q_read.get()
                if item is None:
                    try:  # wake the next worker
                        q_read.put_nowait(None)
                    except queue.Full:
                        pass
                    return
                seq, path, value, nbytes = item
                if not put(q_done, (seq, path, quantize_one(path, value), nbytes)):
                    return
        except BaseException as e:  # re-raised on the caller's thread
            errors.append(e)
        finally:
            put(q_done, None)

    threads = [threading.Thread(target=reader, name="dispatch-read", daemon=True)]
    threads += [threading.Thread(target=quantizer, name=f"dispatch-quantize-{i}", daemon=True)
                for i in range(n_quant)]
    for t in threads:
        t.start()
    try:
        pending: dict = {}
        next_seq = 0
        done = 0
        while done < n_quant:
            item = q_done.get()
            if item is None:
                done += 1
                continue
            pending[item[0]] = item[1:]
            while next_seq in pending:
                submit_one(*pending.pop(next_seq))
                next_seq += 1
        if not errors and (pending or next_seq != len(device_paths)):
            raise RuntimeError(f"the load pipeline dropped leaves: {sorted(pending)}")
        with phases("transfer_submit"):
            submitter.finish()
    finally:
        # stop, then drain the queues so no worker stays parked on a full
        # one, then wake any worker parked on an empty one
        stop.set()
        gate.release(gate.limit)
        for q in (q_read, q_done):
            with contextlib.suppress(queue.Empty):
                while True:
                    q.get_nowait()
            with contextlib.suppress(queue.Full):
                q.put_nowait(None)
        for t in threads:
            t.join(timeout=60)
    if errors:
        raise errors[0]
    return out


def _to_pinned_host(value: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``value`` in host memory the card can copy from asynchronously:
    pinned for a CUDA ``device``; for a CPU device there is nothing to pin,
    and it is a plain copy in memory."""
    if device.type != "cuda":
        return value.clone()
    out = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
    out.copy_(value)
    return out


class _DiskWeight:
    """A lazy handle to a weight in an offload folder."""

    def __init__(self, name: str, folder: str, shape: tuple, dtype: torch.dtype):
        self.name = name
        self.folder = folder
        self.shape = tuple(shape)
        self.dtype = dtype

    def load(self) -> torch.Tensor:
        """The weight as a CPU tensor viewing its file."""
        from .offload import load_offload_index, load_offloaded_weight

        info = load_offload_index(self.folder)[self.name]
        return load_offloaded_weight(os.path.join(self.folder, f"{self.name}.dat"), info)

    def __repr__(self):
        return f"_DiskWeight({self.name}, shape={self.shape}, dtype={self.dtype})"
