"""Flat weight trees in the reference's checkpoint formats: safetensors
(single file, or sharded with an ``.index.json``) and pickle ``.bin``.

Counterpart of ``accelerate_tpu/utils/serialization.py``. A tree is a
nested dict (lists and tuples index by position) whose leaves are
tensors; :func:`flatten_pytree` names each leaf by its ``/``-joined path,
with dict keys sorted as JAX sorts them, so a tree and the reference's
tree of the same structure flatten to the same names in the same order.
``QuantizedWeight`` / ``QuantizedScale`` nodes flatten to their children
``0`` (data), ``1`` (scale) and, for a scale, ``2`` (offset), as the
reference's pytree nodes do.

The safetensors format is read and written here, without the
``safetensors`` package: 8 bytes of little-endian header length, a JSON
header of ``{name: {"dtype", "shape", "data_offsets"}}`` (and
``__metadata__``), then the raw bytes. bfloat16 is torch's own. Reading
maps the file once (copy-on-write, so the tensors are writable views that
never write back) and returns CPU tensors viewing it: no byte is read
until a consumer touches it (:func:`load_flat_dict`).

The reference's per-rank checkpoints (``att_dist_v1``: a
``<base>.rank<r>.safetensors`` and manifest per process) are written by
:func:`save_entries_dist` and read back whole by :func:`load_dist` (and
so by :func:`load_flat_dict` given the base path). Not carried: the
native parallel pread that serves the reference's, and its fallback to
the ``safetensors`` library for dtype codes this reader does not know
(they raise).
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Any, Mapping

import numpy as np
import torch

FLAT_SEP = "/"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U64": torch.uint64,
    "U32": torch.uint32, "U16": torch.uint16, "U8": torch.uint8, "BOOL": torch.bool,
}
_CODES = {dt: code for code, dt in _DTYPES.items()}


def _children(node):
    """(key, child) pairs of a tree node, or None for a leaf."""
    if isinstance(node, Mapping):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    flat_children = getattr(node, "tree_children", None)
    if flat_children is not None:
        return [(str(i), v) for i, v in enumerate(flat_children())]
    return None


def flatten_pytree(tree, is_leaf=None) -> dict[str, Any]:
    """Tree -> flat ``{path: leaf}`` with ``/``-joined keys (dict keys
    sorted; None is an empty subtree, as in JAX). ``is_leaf(node)`` true
    stops the walk at ``node``, as JAX's ``is_leaf`` does."""
    out = {}

    def walk(node, prefix):
        if node is None:
            return
        kids = None if is_leaf is not None and is_leaf(node) else _children(node)
        if kids is None:
            out[prefix] = node
            return
        for key, child in kids:
            walk(child, f"{prefix}{FLAT_SEP}{key}" if prefix else key)

    walk(tree, "")
    return out


def unflatten_to_like(flat: Mapping[str, Any], like=None):
    """Rebuild a tree with the structure of ``like`` from a flat dict;
    a leaf of ``like`` absent from ``flat`` raises. With no ``like``, the
    tree is the nested dicts the ``/``-joined names spell out."""
    if like is None:
        nested: dict = {}
        for key, val in flat.items():
            node = nested
            *parents, last = key.split(FLAT_SEP)
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = val
        return nested

    def build(node, prefix):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            if prefix in flat:
                return flat[prefix]
            raise KeyError(f"missing key {prefix!r} in checkpoint (have {len(flat)} keys)")
        rebuilt = {k: build(v, f"{prefix}{FLAT_SEP}{k}" if prefix else k) for k, v in kids}
        if isinstance(node, Mapping):
            return {k: rebuilt[str(k)] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuilt[str(i)] for i in range(len(node)))
        return node.tree_rebuild([rebuilt[k] for k, _ in kids])

    return build(like, "")


def _as_tensor(x) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (numpy arrays and tensors)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to("cpu").contiguous()


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def write_safetensors_streaming(path: str, entries, metadata: dict | None = None):
    """Write a safetensors file fetching one tensor at a time.

    ``entries``: a list of ``(key, shape, dtype, fetch)``; ``fetch()``
    returns the tensor when its turn comes, or an iterable of tensors
    whose bytes, in order, make it up (a stacked leaf written layer slice
    by layer slice, so the host never holds more than one slice). Within
    the file, tensors are laid out widest dtype first (the order is
    otherwise kept), so every tensor starts aligned to its element size."""
    entries = sorted(entries, key=lambda e: -e[2].itemsize)
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for key, shape, dtype, _ in entries:
        nbytes = _nbytes(shape, dtype)
        header[key] = {"dtype": _CODES[dtype], "shape": [int(s) for s in shape],
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)  # tensors start 8-byte aligned
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for key, shape, dtype, fetch in entries:
            got = fetch()
            pieces = [got] if isinstance(got, (torch.Tensor, np.ndarray)) else got
            written = 0
            for piece in pieces:
                t = _as_tensor(piece)
                if t.dtype != dtype:
                    raise ValueError(f"streaming write: {key} produced {t.dtype}, header says "
                                     f"{dtype}")
                f.write(t.reshape(-1).view(torch.uint8).numpy())
                written += t.numel() * t.element_size()
            expect = header[key]["data_offsets"][1] - header[key]["data_offsets"][0]
            if written != expect:
                raise ValueError(f"streaming write: {key} produced {written} bytes, header "
                                 f"says {expect}")
    return path


def save_entries(entries, path: str | os.PathLike, max_shard_size: int | None = None) -> list[str]:
    """Write ``(key, shape, dtype, fetch)`` entries as one safetensors file,
    or, with ``max_shard_size``, as shards plus an index (the reference's
    shard rule: a new shard starts when the next tensor would overflow a
    non-empty one)."""
    path = str(path)
    metadata = {"format": "np"}  # the reference's files carry it
    if max_shard_size is None:
        return [write_safetensors_streaming(path, entries, metadata)]
    shards, sizes = [[]], [0]
    for entry in entries:
        nbytes = _nbytes(entry[1], entry[2])
        if sizes[-1] + nbytes > max_shard_size and shards[-1]:
            shards.append([])
            sizes.append(0)
        shards[-1].append(entry)
        sizes[-1] += nbytes
    if len(shards) == 1:
        return [write_safetensors_streaming(path, entries, metadata)]
    base, ext = os.path.splitext(path)
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    files = []
    for i, shard in enumerate(shards):
        name = f"{base}-{i + 1:05d}-of-{len(shards):05d}{ext}"
        write_safetensors_streaming(name, shard, metadata)
        files.append(name)
        for entry in shard:
            index["weight_map"][entry[0]] = os.path.basename(name)
    with open(path + ".index.json", "w") as f:
        json.dump(index, f, indent=2)
    return files


def materialize_entries(entries) -> dict[str, torch.Tensor]:
    """``(key, shape, dtype, fetch)`` entries as ``{key: CPU tensor}``, each
    fetched whole (a stacked leaf's slices concatenated)."""
    out = {}
    for key, shape, dtype, fetch in entries:
        got = fetch()
        pieces = [got] if isinstance(got, (torch.Tensor, np.ndarray)) else list(got)
        flat = torch.cat([_as_tensor(p).reshape(-1) for p in pieces])
        if flat.dtype != dtype:
            raise ValueError(f"{key} produced {flat.dtype}, its entry says {dtype}")
        out[key] = flat.reshape(shape)
    return out


def save_pytree(tree, path: str | os.PathLike, safe_serialization: bool = True,
                max_shard_size: int | None = None):
    """Save a tree of tensors (or numpy arrays). With ``max_shard_size``
    writes shards and an index json. ``safe_serialization=False`` pickles
    the flat dict of numpy arrays, as the reference does (numpy has no
    bfloat16 without ``ml_dtypes``, so a bf16 leaf raises there)."""
    path = str(path)
    flat = {k: _as_tensor(v) for k, v in flatten_pytree(tree).items()}
    if not safe_serialization:
        bad = [k for k, v in flat.items() if v.dtype == torch.bfloat16]
        if bad:
            raise ValueError(f"pickle checkpoints hold numpy arrays, which have no bfloat16: "
                             f"{bad[:3]}; use safetensors")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({k: v.numpy() for k, v in flat.items()}, f)
        return [path]
    entries = [(k, tuple(v.shape), v.dtype, (lambda t: lambda: t)(v)) for k, v in flat.items()]
    return save_entries(entries, path, max_shard_size)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _index_path(path: str) -> str | None:
    if path.endswith(".index.json"):
        return path
    if not os.path.exists(path) and os.path.exists(path + ".index.json"):
        return path + ".index.json"
    return None


def _dist_manifests(base: str) -> list:
    return sorted(glob.glob(f"{glob.escape(base)}.rank*.manifest.json"))


def save_entries_dist(entries, base: str | os.PathLike, process_index: int,
                      num_processes: int) -> list[str]:
    """This process's share of a per-rank checkpoint, the reference's
    format (``save_pytree_dist``, ``att_dist_v1``): its entries (every
    ``num_processes``-th, from ``process_index``; each whole, one chunk at
    offset 0) in ``<base>.rank<r>.safetensors``, and
    ``<base>.rank<r>.manifest.json`` placing each chunk in its global
    tensor. Every process calls it with the same entries and fetches every
    one of them in their order (a sharded tensor's fetch gathers it, a
    collective), keeping its own on the host: a process holds its share,
    and one whole tensor on the device at a time."""
    base = str(base)
    fname = f"{base}.rank{process_index}.safetensors"
    manifest = {"format": "att_dist_v1", "num_processes": int(num_processes), "tensors": {}}
    chunks = []
    for i, (key, shape, dtype, fetch) in enumerate(entries):
        got = fetch()
        pieces = [got] if isinstance(got, (torch.Tensor, np.ndarray)) else got
        pieces = [_as_tensor(p) for p in pieces]
        if i % num_processes != process_index:
            continue
        start = [0] * len(shape)
        ck = f"{key}@{'_'.join(map(str, start))}"
        chunks.append((ck, shape, dtype, (lambda ps: lambda: ps)(pieces)))
        manifest["tensors"][key] = {
            "shape": [int(x) for x in shape], "dtype": _CODES[dtype],
            "chunks": [{"key": ck, "file": os.path.basename(fname), "start": start,
                        "shape": [int(x) for x in shape]}]}
    save_entries(chunks, fname)
    with open(f"{base}.rank{process_index}.manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    return [fname]


def load_dist(base: str) -> dict[str, torch.Tensor]:
    """A per-rank checkpoint reassembled (the reference's ``_load_dist``):
    every rank manifest the save recorded must be there and each tensor's
    chunks must tile its global volume, else it raises."""
    manifests = _dist_manifests(base)
    if not manifests:
        raise FileNotFoundError(f"no .rank*.manifest.json next to {base}")
    folder = os.path.dirname(base) or "."
    out, covered, per_file, expected = {}, {}, {}, None
    for mpath in manifests:
        with open(mpath) as f:
            man = json.load(f)
        if man.get("num_processes") is not None:
            expected = max(expected or 0, int(man["num_processes"]))
        for key, info in man["tensors"].items():
            if key not in out:
                out[key] = torch.empty(tuple(info["shape"]),
                                       dtype=_dtype_of_code(mpath, key, info["dtype"]))
                covered[key] = 0
            for ck in info["chunks"]:
                per_file.setdefault(os.path.join(folder, ck["file"]), []).append((key, ck))
                covered[key] += int(np.prod(ck["shape"])) if ck["shape"] else 1
    if expected is not None and len(manifests) < expected:
        raise ValueError(f"distributed checkpoint {base} is incomplete: {len(manifests)} rank "
                         f"manifest(s) found but the save recorded {expected} processes")
    bad = [k for k in out if covered[k] != out[k].numel()]
    if bad:
        raise ValueError(f"distributed checkpoint {base} is incomplete: chunk volume does not "
                         f"tile the global shape for {bad[:5]}")
    for fpath, refs in per_file.items():
        data = _load_safetensors(fpath)
        for key, ck in refs:
            sl = tuple(slice(a, a + n) for a, n in zip(ck["start"], ck["shape"]))
            out[key][sl] = data[ck["key"]]
    return out


def _read_header(path: str):
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
    return header, 8 + header_len


def _is_safetensors(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            header_len = int.from_bytes(f.read(8), "little")
            if header_len <= 0 or header_len > 100_000_000:
                return False
            return f.read(1) == b"{"
    except OSError:
        return False


def peek_flat_structs(path: str | os.PathLike) -> dict[str, torch.Tensor] | None:
    """Shapes and dtypes from safetensors header(s), reading no tensor
    bytes: ``{path: meta tensor}``. None for a format without a cheap
    header (pickle)."""
    path = str(path)
    manifests = _dist_manifests(path)
    if manifests:
        out = {}
        for mpath in manifests:
            with open(mpath) as f:
                tensors = json.load(f)["tensors"]
            for key, info in tensors.items():
                out[key] = torch.empty(tuple(info["shape"]), device="meta",
                                       dtype=_dtype_of_code(mpath, key, info["dtype"]))
        return out
    index = _index_path(path)
    if index is not None:
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out = {}
        for fname in sorted(set(weight_map.values())):
            part = peek_flat_structs(os.path.join(os.path.dirname(index), fname))
            if part is None:
                return None
            out.update(part)
        return out
    if not (path.endswith(".safetensors") or _is_safetensors(path)):
        return None
    header, _ = _read_header(path)
    return {name: torch.empty(info["shape"], dtype=_dtype_of_code(path, name, info["dtype"]),
                              device="meta")
            for name, info in header.items() if name != "__metadata__"}


def _dtype_of_code(path: str, name: str, code: str) -> torch.dtype:
    if code not in _DTYPES:
        raise ValueError(f"{path}: tensor {name!r} has dtype code {code!r}, which this reader "
                         f"does not know (known: {sorted(_DTYPES)})")
    return _DTYPES[code]


def load_flat_dict(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Load a flat ``{path: tensor}`` dict from a safetensors file, a
    sharded index (or the path it indexes), or a pickle. Safetensors
    tensors are lazy views of the mapped file. Pickle runs code from the
    file: load only checkpoints this program or one you trust wrote."""
    path = str(path)
    if _dist_manifests(path):
        return load_dist(path)
    index = _index_path(path)
    if index is not None:
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out = {}
        for fname in sorted(set(weight_map.values())):
            out.update(load_flat_dict(os.path.join(os.path.dirname(index), fname)))
        return out
    if path.endswith(".safetensors") or _is_safetensors(path):
        return _load_safetensors(path)
    with open(path, "rb") as f:
        flat = pickle.load(f)
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            for k, v in flat.items()}


def _load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """One safetensors file: tensors viewing one copy-on-write map of the
    file. Headers whose spans disagree with shape and dtype, or fall
    outside the file, raise."""
    file_size = os.path.getsize(path)
    header, data_start = _read_header(path)
    parsed = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _dtype_of_code(path, name, info["dtype"])
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        nbytes = _nbytes(shape, dtype)
        if end - begin != nbytes:
            raise ValueError(
                f"corrupt safetensors header in {path}: tensor {name!r} spans "
                f"{end - begin} bytes but dtype/shape imply {nbytes}")
        if begin < 0 or data_start + end > file_size:
            raise ValueError(
                f"corrupt safetensors header in {path}: tensor {name!r} offsets "
                f"[{begin}, {end}) fall outside the file ({file_size} bytes)")
        parsed.append((name, shape, dtype, data_start + begin, nbytes))
    if not parsed:
        return {}
    mm = torch.from_numpy(np.memmap(path, np.uint8, mode="c"))
    out = {}
    for name, shape, dtype, off, n in parsed:
        raw = mm[off:off + n]
        # a tensor not aligned to its element size (another writer's
        # layout) cannot be viewed in place: it is read into memory
        out[name] = (raw if off % dtype.itemsize == 0 else raw.clone()).view(dtype).reshape(shape)
    return out
