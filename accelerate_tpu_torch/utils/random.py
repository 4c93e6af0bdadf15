"""Seeding, and the random states a checkpoint carries.

Counterpart of ``accelerate_tpu/utils/random.py`` (``set_seed``,
``rng_state_dict``, ``load_rng_state_dict``). The reference's checkpoint
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
