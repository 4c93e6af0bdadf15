"""Seeding, and the random states a checkpoint carries.

Counterpart of ``accelerate_tpu/utils/random.py`` (``set_seed``,
``synchronize_rng_state(s)``, ``rng_state_dict``, ``load_rng_state_dict``). The reference's checkpoint
entry is ``{"python", "numpy", "keychain", "torch"}``, where ``keychain``
is its counter-based key streams (``{"seed", "counters"}``: the last
``set_seed`` and the keys drawn from each named stream). The port keeps
the same record: the ``"dropout"`` stream is the residual dropout's
(:func:`next_key`, ``models/decoder.py``), one key per training forward,
so a checkpoint carries the dropout stream's position with the other
random states and a resumed run draws the masks the uninterrupted one
would. A ``keychain`` read from the reference's file is kept and written
back as read. Beside the CPU generator it saves every CUDA device's
generator under ``torch_cuda``, which the reference ignores.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

# the reference's key-stream state, carried through this process's
# checkpoints: the process-wide counterpart of its global KeyChain
_keychain = {"seed": 0, "counters": {}}


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False):
    """Seed python's, numpy's and torch's generators (torch's CPU and every
    CUDA device's). ``device_specific`` adds the process index.
    ``deterministic`` asks torch for deterministic algorithms."""
    global _keychain
    seed = int(seed)
    if device_specific:
        from ..state import current_topology

        seed += current_topology()[0]
    random.seed(seed)
    np.random.seed(seed & 0xFFFFFFFF)
    torch.manual_seed(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    _keychain = {"seed": seed, "counters": {}}


def next_key(stream: str) -> tuple:
    """``(seed, counter)`` of stream ``stream``'s next key (the keychain's
    seed, and how many keys the stream gave before this one); advances
    the stream."""
    count = int(_keychain["counters"].get(stream, 0))
    _keychain["counters"][stream] = count + 1
    return int(_keychain["seed"]), count


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


RNG_TYPES = ("python", "numpy", "torch", "cuda", "keychain", "generator")


def synchronize_rng_state(rng_type: str, generator: Optional[torch.Generator] = None):
    """Give every process the main process's state of one generator
    (the reference's, random.py:143): ``"python"``, ``"numpy"``,
    ``"torch"`` (the CPU generator), ``"cuda"`` (this process's card's),
    ``"keychain"`` (the port's key streams: the dropout masks) or
    ``"generator"`` (``generator``). ``"jax"`` (the reference's key streams,
    which need no sync) is the keychain's here. Nothing on one process."""
    from .operations import broadcast_object_list, num_processes

    rng_type = str(getattr(rng_type, "value", rng_type)).lower()
    if rng_type == "jax":
        rng_type = "keychain"
    if rng_type not in RNG_TYPES:
        raise ValueError(f"rng_type must be one of {RNG_TYPES} (or 'jax'), got {rng_type!r}")
    if num_processes() == 1:
        return
    global _keychain
    get, put = {
        "python": (random.getstate, random.setstate),
        "numpy": (np.random.get_state, np.random.set_state),
        "torch": (torch.get_rng_state, torch.set_rng_state),
        "cuda": (torch.cuda.get_rng_state, torch.cuda.set_rng_state),
        "keychain": (lambda: {"seed": _keychain["seed"],
                              "counters": dict(_keychain["counters"])}, None),
        "generator": ((lambda: generator.get_state()) if generator is not None else None,
                      (lambda st: generator.set_state(st)) if generator is not None else None),
    }[rng_type]
    if get is None:
        return  # "generator" without one
    state = broadcast_object_list([get()])[0]
    if rng_type == "keychain":
        _keychain = {"seed": int(state["seed"]), "counters": dict(state["counters"])}
    else:
        put(state)


def synchronize_rng_states(rng_types, generator: Optional[torch.Generator] = None):
    for rng_type in rng_types:
        synchronize_rng_state(rng_type, generator=generator)
