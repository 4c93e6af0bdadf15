"""Port-to-port training resumes, bit for bit, on the CPU (split from
tests/test_torch_checkpointing.py, whose ``_resume_case`` they run:
``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ 128 in fp32).

Port to port, the resumed run is bit-identical to the uninterrupted one
(losses, learning rates, a torch draw, every parameter) through the
eager loop with ``accumulate`` and through ``build_train_step``, over a
shuffled and an unshuffled loader (with pickles, and the controls that
lack the optimizer file or the loader's position:
tests/test_torch_checkpointing_resume_controls.py).
"""

import pytest

import torch

from test_torch_checkpointing import _resume_case


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "build_train_step"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_port_resume_is_bit_exact(tmp_path, shuffle, fused):
    a, b = _resume_case(tmp_path, shuffle, fused=fused)
    assert a[0] == b[0]  # losses and learning rates
    assert torch.equal(a[1], b[1])  # the torch generator
    for k, v in b[2].items():
        assert torch.equal(a[2][k], v), k
