"""Seeding, and the random states a checkpoint carries.

Counterpart of ``accelerate_tpu/utils/random.py`` (``set_seed``,
``rng_state_dict``, ``load_rng_state_dict``). The reference's checkpoint
entry is ``{"python", "numpy", "keychain", "torch"}``, where ``keychain``
is its counter-based JAX key streams (``{"seed", "counters"}``). The port
has no JAX streams: it writes a ``keychain`` of the last ``set_seed``
with no counters, so the reference's loader (which indexes the entry)
accepts the file, and it keeps a ``keychain`` it reads to write it back
unchanged. Beside the CPU generator it saves every CUDA device's
generator under ``torch_cuda``, which the reference ignores.
"""

from __future__ import annotations

import random

import numpy as np
import torch

# the reference's key-stream state, carried through this process's
# checkpoints: the process-wide counterpart of its global KeyChain
_keychain = {"seed": 0, "counters": {}}


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False):
    """Seed python's, numpy's and torch's generators (torch's CPU and every
    CUDA device's). ``device_specific`` would add the process index, which
    is 0 in the port's one process. ``deterministic`` asks torch for
    deterministic algorithms."""
    global _keychain
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed & 0xFFFFFFFF)
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    _keychain = {"seed": seed, "counters": {}}


def rng_state_dict() -> dict:
    """Every random state this process resumes from: python, numpy, torch's
    CPU generator, the reference's ``keychain`` and, where CUDA has been
    initialised, each CUDA device's generator (``torch_cuda``)."""
    state = {
        "python": random.getstate(),
        "numpy": np.random.get_state(),
        "keychain": {"seed": _keychain["seed"], "counters": dict(_keychain["counters"])},
        "torch": torch.get_rng_state(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["torch_cuda"] = torch.cuda.get_rng_state_all()
    return state


def load_rng_state_dict(state: dict):
    """Restore what :func:`rng_state_dict` (or the reference's) saved. A
    ``torch_cuda`` entry needs CUDA, and as many devices as it saved."""
    global _keychain
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    if "keychain" in state:
        kc = state["keychain"]
        _keychain = {"seed": int(kc["seed"]), "counters": dict(kc["counters"])}
    if "torch" in state:
        torch.set_rng_state(state["torch"])
    if "torch_cuda" in state:
        torch.cuda.set_rng_state_all(state["torch_cuda"])
