"""Ring attention on 4 gloo ranks against the JAX package's
``ring_attention_sharded`` and the lockstep composition, with the checks
and inputs of tests/test_torch_ring.py (its 2-rank world; split so that
pytest's ``--dist loadfile`` runs the two worlds on two workers).
"""

import pytest

from test_torch_ring import check_lockstep, check_reference, spawn_world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(4, tmp_path_factory)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_reference(world, causal):
    check_reference(world, causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lockstep_is_the_ring_bit_for_bit(world, causal):
    check_lockstep(world, causal)
