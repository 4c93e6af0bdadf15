"""Disk-backed weight store for big-model offload.

Counterpart of ``accelerate_tpu/utils/offload.py``, in its layout: one
raw ``<name>.dat`` file per weight (a numpy memmap; bfloat16 stored as a
uint16 view, a scalar as one element) and an ``index.json`` of
``{name: {"dtype": numpy dtype name, "shape": [...]}}``, so a folder
either package writes, the other reads. Weights read back as CPU tensors
viewing a copy-on-write map of their file: nothing is read until touched.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int8", ...)."""
    return str(dtype).removeprefix("torch.")


def offload_weight(weight, weight_name: str, offload_folder: str,
                   index: Optional[dict] = None) -> dict:
    """Write one tensor (or numpy array) as a raw memmap file; returns the
    updated index."""
    index = index if index is not None else {}
    t = weight if isinstance(weight, torch.Tensor) else torch.from_numpy(np.asarray(weight))
    t = t.detach().to("cpu").contiguous()
    dtype = _dtype_name(t.dtype)
    arr = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    os.makedirs(offload_folder, exist_ok=True)
    path = os.path.join(offload_folder, f"{weight_name}.dat")
    file_array = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape or (1,))
    file_array[:] = arr.reshape(file_array.shape)
    file_array.flush()
    index[weight_name] = {"dtype": dtype, "shape": list(t.shape)}
    return index


def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """Read one weight back: a CPU tensor viewing its file."""
    shape = tuple(weight_info["shape"])
    dtype = weight_info["dtype"]
    arr = np.memmap(weight_file, dtype=np.uint16 if dtype == _BF16 else np.dtype(dtype),
                    mode="c", shape=shape or (1,))
    t = torch.from_numpy(arr)
    if dtype == _BF16:
        t = t.view(torch.bfloat16)
    return t.reshape(shape)


def save_offload_index(index: dict, offload_folder: str) -> None:
    with open(os.path.join(offload_folder, "index.json"), "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    path = os.path.join(offload_folder, "index.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def offload_state_dict(save_dir: str, state_dict: Mapping) -> None:
    """Offload a whole flat ``{name: tensor}`` dict."""
    index = load_offload_index(save_dir)
    for name, value in state_dict.items():
        index = offload_weight(value, name, save_dir, index)
    save_offload_index(index, save_dir)


class OffloadedWeightsLoader(Mapping):
    """Read-only Mapping over in-memory weights and a memmap folder;
    folder values load lazily."""

    def __init__(self, state_dict: Optional[Mapping] = None, save_folder: Optional[str] = None):
        if state_dict is None and save_folder is None:
            raise ValueError("need state_dict and/or save_folder")
        self.state_dict = dict(state_dict or {})
        self.save_folder = save_folder
        self.index = load_offload_index(save_folder) if save_folder else {}
        self.all_keys = list(self.state_dict)
        self.all_keys.extend(k for k in self.index if k not in self.all_keys)

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        if key not in self.index:
            raise KeyError(key)
        return load_offloaded_weight(os.path.join(self.save_folder, f"{key}.dat"),
                                     self.index[key])

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)
