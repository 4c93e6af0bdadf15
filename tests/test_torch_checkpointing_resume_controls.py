"""Port-to-port training resumes, on the CPU (split from
tests/test_torch_checkpointing.py, whose ``_resume_case`` they run:
``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ 128 in fp32): a resume from
pickles is bit-identical to the uninterrupted run, and one that lacks
the optimizer file or the loader's position is not (the controls of
tests/test_torch_checkpointing_resume.py's bit-exact check).
"""

import pickle

import numpy as np
import pytest

import torch

from test_torch_checkpointing import _bit_equal, _resume_case


def test_port_resume_from_pickles_is_bit_exact(tmp_path):
    a, b = _resume_case(tmp_path, True, safe=False)
    ckpt = tmp_path / "checkpoints" / "checkpoint_0"
    assert (ckpt / "model_0.bin").exists() and (ckpt / "optimizer_0.bin").exists()
    with open(ckpt / "optimizer_0.bin", "rb") as f:
        flat = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for v in flat.values()) and "0/count" in flat
    assert _bit_equal(a, b)


@pytest.mark.parametrize("withhold", ["optimizer", "loader"])
def test_resume_check_sees_a_lost_state(tmp_path, withhold):
    """A resume without the moments, or without the loader's position
    (the epoch restarts), must not pass the bit-exact check."""
    a, b = _resume_case(tmp_path, True, withhold=withhold)
    assert not _bit_equal(a, b)
    assert any(not torch.equal(a[2][k], v) for k, v in b[2].items())
