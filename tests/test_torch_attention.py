"""The port's plain attention (``accelerate_tpu_torch/ops/attention.py``)
against the JAX package's, on the same numpy-seeded fp32 inputs.

The JAX side runs each Pallas kernel as its own tests run it on the CPU:
through the interpreter (``impl="interpret"``) and through its plain
reference (``impl="dense"``). The port's side is the plain PyTorch
version the kernel wrappers take for CPU tensors (the CUDA kernels are
held against the same plain versions on the card by ``chip_smoke.py``).

Tolerance 2e-5 (as tests/test_prefill_kernel.py): fp32 softmax and
matmuls summed in another order (online softmax in the interpreter,
einsum reassociation in PyTorch) differ at reassociation-level noise.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops import attention as ja
from accelerate_tpu_torch.ops import attention as ta
from accelerate_tpu_torch.ops import kernels

ATOL = 2e-5
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches(h, kvh, causal):
    rng = np.random.RandomState(0)
    q = rng.standard_normal((2, h, 5, 16)).astype(np.float32)
    k = rng.standard_normal((2, kvh, 7, 16)).astype(np.float32)
    v = rng.standard_normal((2, kvh, 7, 16)).astype(np.float32)
    bias = np.where(rng.random_sample((2, 1, 5, 7)) < 0.2, ta.NEG_INF, 0.0).astype(np.float32)
    bias[..., 0] = 0.0  # keep every row attending something
    ref = ja.mha_reference(_j(q), _j(k), _j(v), causal=causal, bias=_j(bias))
    got = ta.mha_reference(_t(q), _t(k), _t(v), causal=causal, bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("per_slot", [False, True])
def test_masked_dense_decode_matches(per_slot):
    """The masked-dense decode tail: shared [Sq] and per-slot [B, Sq]
    positions."""
    rng = np.random.RandomState(1)
    q = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    k = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 24, 16)).astype(np.float32)
    pos = (np.array([[3, 4], [10, 11], [22, 23]]) if per_slot
           else np.array([5, 6])).astype(np.int32)
    ref = ja.decode_attention(_j(q), _j(k), _j(v), q_positions=_j(pos), impl="dense")
    got = ta.decode_attention_dense(_t(q), _t(k), _t(v), q_positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_gather_kv_pages_matches():
    rng = np.random.RandomState(2)
    pages = rng.standard_normal((9, 2, 8, 16)).astype(np.float32)
    table = np.array([[3, 1, 0, 0], [2, 2, 5, 0]], np.int32)  # duplicates + parking
    ref = ja.gather_kv_pages(_j(pages), _j(table))
    got = ta.gather_kv_pages(_t(pages), _t(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- paged decode --------------------------------------------------------------


def _decode_case(rng, h, kvh, sq, d=16, ps=8, per_slot=6):
    """Four live slots of mixed length plus one parked slot. Live tables
    are position-ordered over shuffled pages, unallocated tail entries
    point at the parking page 0, one slot repeats a page past its
    frontier, and the parked slot's row is all parking at the last
    position."""
    lengths = [1, ps, 2 * ps + 3, ps * per_slot]
    b = len(lengths) + 1
    live = [-(-n // ps) for n in lengths]
    num_pages = 1 + sum(live)
    perm = 1 + rng.permutation(num_pages - 1)
    table = np.zeros((b, per_slot), np.int32)
    at = 0
    for s, n in enumerate(live):
        table[s, :n] = perm[at:at + n]
        at += n
    table[0, 1] = table[0, 0]  # duplicate entry past slot 0's frontier
    last = ps * per_slot - 1
    pos = np.zeros((b, sq), np.int32)
    for s, n in enumerate(lengths):
        pos[s] = np.maximum(n - sq + np.arange(sq), 0)
    pos[b - 1] = last - sq + 1 + np.arange(sq)  # parked
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, kvh, ps, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, kvh, ps, d)).astype(np.float32)
    return q, kp, vp, table, pos


@pytest.mark.parametrize("impl", ["interpret", "dense"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)])
def test_plain_paged_decode_matches(h, kvh, sq, impl):
    rng = np.random.RandomState(3)
    q, kp, vp, table, pos = _decode_case(rng, h, kvh, sq)
    ref = ja.paged_decode_attention(_j(q), _j(kp), _j(vp), page_table=_j(table),
                                    q_positions=_j(pos), impl=impl)
    before = dict(kernels.launch_counts)
    got = ta.paged_decode_attention(_t(q), _t(kp), _t(vp), page_table=_t(table),
                                    q_positions=_t(pos))
    assert kernels.launch_counts == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_plain_paged_decode_ignores_parking_garbage():
    """Garbage in the parking page and in pages past each frontier cannot
    perturb any live slot's output."""
    rng = np.random.RandomState(4)
    q, kp, vp, table, pos = _decode_case(rng, 4, 2, 1)
    clean = ta.paged_decode_attention(_t(q), _t(kp), _t(vp), page_table=_t(table),
                                      q_positions=_t(pos))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e6, -1e6
    dirty = ta.paged_decode_attention(_t(q), _t(kp2), _t(vp2), page_table=_t(table),
                                      q_positions=_t(pos))
    np.testing.assert_array_equal(dirty.numpy()[:-1], clean.numpy()[:-1])


# -- packed ragged prefill -------------------------------------------------------


def _packed_case(rng, packs, *, h=4, kvh=2, d=16, ps=8, bt=8, pad_blocks=0):
    """One packed dispatch from ``packs`` = [(hist, tail), ...]: rows of one
    slot contiguous and position-ordered, each tail padded to the token
    block (pads keep the slot id, pos -1), then ``pad_blocks`` whole pad
    blocks (slot -1). Position-ordered tables over disjoint live pages,
    page 0 parked."""
    s_n = max(1, len(packs))
    cap = max(bt, sum(-(-t // bt) * bt for _, t in packs) + pad_blocks * bt)
    row_slot = np.full((cap,), -1, np.int32)
    row_pos = np.full((cap,), -1, np.int32)
    slot_hist = np.zeros((s_n,), np.int32)
    per = max(1, max((-(-(hi + t) // ps) for hi, t in packs), default=1))
    table = np.zeros((s_n, per), np.int32)
    r = 0
    for s, (hist, tail) in enumerate(packs):
        blocks = -(-tail // bt)
        row_slot[r:r + blocks * bt] = s
        row_pos[r:r + tail] = np.arange(hist, hist + tail)
        r += blocks * bt
        slot_hist[s] = hist
        need = -(-(hist + tail) // ps)
        table[s, :need] = 1 + s * per + np.arange(need)
    npages = 1 + s_n * per
    arrays = dict(
        q=rng.standard_normal((1, h, cap, d)).astype(np.float32),
        k_new=rng.standard_normal((1, kvh, cap, d)).astype(np.float32),
        v_new=rng.standard_normal((1, kvh, cap, d)).astype(np.float32),
        k_pages=rng.standard_normal((npages, kvh, ps, d)).astype(np.float32),
        v_pages=rng.standard_normal((npages, kvh, ps, d)).astype(np.float32),
    )
    meta = dict(page_table=table, row_slot=row_slot, row_pos=row_pos,
                slot_hist=slot_hist)
    return arrays, meta, (row_slot >= 0) & (row_pos >= 0)


PACKS = {
    # a prefix-hit tail, three cold tails (two ending mid-block on pads)
    # and one whole pad block: the serving packer's mixed dispatch
    "mixed_with_hist_and_pads": ([(16, 21), (0, 7), (0, 8), (0, 5)], 1),
    # everything padded: the pack of a dispatch with nothing live
    "all_pad_block": ([], 0),
    # a mid-tail primary: its earlier dispatch left 24 tokens in the
    # arena and this one fills the whole pack
    "mid_tail_primary": ([(24, 32)], 0),
    # prefix frontiers at page boundary -1 / 0 / +1
    "frontier_7": ([(7, 8)], 0),
    "frontier_8": ([(8, 8)], 0),
    "frontier_9": ([(9, 8)], 1),
}


@pytest.mark.parametrize("impl", ["interpret", "dense"])
@pytest.mark.parametrize("case", sorted(PACKS))
def test_plain_ragged_prefill_matches(case, impl):
    packs, pad_blocks = PACKS[case]
    rng = np.random.RandomState(5)
    arrays, meta, valid = _packed_case(rng, packs, pad_blocks=pad_blocks)
    ref = ja.ragged_prefill_attention(
        *(_j(arrays[k]) for k in ("q", "k_new", "v_new", "k_pages", "v_pages")),
        **{k: _j(v) for k, v in meta.items()}, impl=impl, token_block=8)
    before = dict(kernels.launch_counts)
    got = ta.ragged_prefill_attention(
        *(_t(arrays[k]) for k in ("q", "k_new", "v_new", "k_pages", "v_pages")),
        **{k: _t(v) for k, v in meta.items()}, token_block=8)
    assert kernels.launch_counts == before
    out, ref_out = got[0].numpy(), np.asarray(ref[0])
    np.testing.assert_allclose(out[0][:, valid], ref_out[0][:, valid],
                               atol=ATOL, rtol=RTOL, err_msg=case)
    np.testing.assert_array_equal(out[0][:, ~valid], 0.0)
    # the fresh K/V passes through token-major for the caller's scatter
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[2] is None and got[4] is None


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)])
def test_plain_ragged_prefill_gqa_groups(h, kvh):
    rng = np.random.RandomState(6)
    arrays, meta, valid = _packed_case(rng, [(10, 11), (0, 9)], h=h, kvh=kvh)
    ref = ja.ragged_prefill_attention(
        *(_j(arrays[k]) for k in ("q", "k_new", "v_new", "k_pages", "v_pages")),
        **{k: _j(v) for k, v in meta.items()}, impl="interpret", token_block=8)
    got = ta.ragged_prefill_attention(
        *(_t(arrays[k]) for k in ("q", "k_new", "v_new", "k_pages", "v_pages")),
        **{k: _t(v) for k, v in meta.items()}, token_block=8)
    np.testing.assert_allclose(got[0].numpy()[0][:, valid], np.asarray(ref[0])[0][:, valid],
                               atol=ATOL, rtol=RTOL)


def test_ragged_prefill_rejects_bad_packs():
    rng = np.random.RandomState(7)
    arrays, meta, _ = _packed_case(rng, [(0, 8)])
    args = [_t(arrays[k]) for k in ("q", "k_new", "v_new", "k_pages", "v_pages")]
    kw = {k: _t(v) for k, v in meta.items()}
    with pytest.raises(ValueError, match="multiple of the token block"):
        ta.ragged_prefill_attention(*args, **kw, token_block=3)
    with pytest.raises(ValueError, match="batch 1"):
        ta.ragged_prefill_attention(args[0].expand(2, -1, -1, -1), *args[1:], **kw)
