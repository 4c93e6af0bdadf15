"""The port's plain packed ragged prefill against the JAX package at the
edges of the CUDA kernel's 64-row tile, on the CPU.

The kernel (``accelerate_tpu_torch/csrc/prefill_common.cuh``) owns one
64-row tile of the pack per block, lists the slots whose rows the tile
holds, and walks each slot's arena prefix and fresh rows in 64-row kv
tiles. Its plain version, which ``chip_smoke.py`` holds it against on the
card, is held here against the reference's ragged prefill
(``accelerate_tpu.ops.attention.ragged_prefill_attention``, token block 8)
at the shapes that tile must get right: fresh tails longer than 64 rows,
three slots in one 64-row tile, arena prefixes that cross a 64-row tile
and a page edge, a capacity that is not a multiple of 64, GQA groups 1
and 2, bf16 (the reference in the Pallas interpreter and its dense
reference) and int8 / int4 (the interpreter: payloads bit for bit).

Tolerances as tests/test_torch_attention.py and
tests/test_torch_paged_quant.py: out at 2e-5 (fp32 on both sides, summed
in other orders), pad rows exactly 0; payloads bit-exact, scales within
one ulp of the reference's (XLA turns its division by the constant qmax
into a product with the reciprocal).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops import attention as ja
from accelerate_tpu.utils.quantization import quantize_kv as jax_quantize_kv
from accelerate_tpu_torch.ops import attention as ta
from accelerate_tpu_torch.ops import kernels

ATOL = 2e-5
RTOL = 1e-5
PS = 8
BT = 8

# (hist, tail) per slot, then whole pad blocks; every capacity is a
# multiple of the token block and none a multiple of 64
TILE_PACKS = {
    # one slot's fresh tail of 70 rows: two 64-row tiles, the second partial
    "tail_over_64": ([(0, 70)], 0),
    # slots 0-2 and the head of slot 3 share the first 64-row tile (rows
    # 0-23, 24-39, 40-55, 56-63); slot 3 crosses into the second, then a
    # pad block
    "three_slots_a_tile": ([(5, 21), (0, 13), (3, 9), (0, 30)], 1),
    # arena prefixes of 67 (past the 64-row kv tile, mid-page) and 130
    # (past two kv tiles and a page edge), the second slot's 70-row tail
    # crossing the pack's 64-row boundary
    "hist_across_tile_and_page": ([(67, 20), (130, 70)], 0),
    # a 75-row tail over a 9-token prefix, a short cold tail, a tail over
    # a 61-token prefix, a pad block
    "long_mixed": ([(9, 75), (0, 5), (61, 40)], 1),
}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pack(packs, pad_blocks):
    """Row maps and position-ordered page tables (page 0 parked) of one
    packed dispatch: rows of one slot contiguous, each tail padded to the
    token block (pads keep the slot, position -1), then ``pad_blocks``
    whole pad blocks (slot -1)."""
    n_slots = len(packs)
    cap = sum(-(-t // BT) * BT for _, t in packs) + pad_blocks * BT
    assert cap % 64
    row_slot = np.full((cap,), -1, np.int32)
    row_pos = np.full((cap,), -1, np.int32)
    slot_hist = np.zeros((n_slots,), np.int32)
    per = max(-(-(hist + tail) // PS) for hist, tail in packs)
    table = np.zeros((n_slots, per), np.int32)
    r = 0
    for s, (hist, tail) in enumerate(packs):
        blocks = -(-tail // BT)
        row_slot[r:r + blocks * BT] = s
        row_pos[r:r + tail] = np.arange(hist, hist + tail)
        r += blocks * BT
        slot_hist[s] = hist
        need = -(-(hist + tail) // PS)
        table[s, :need] = 1 + s * per + np.arange(need)
    meta = dict(page_table=table, row_slot=row_slot, row_pos=row_pos, slot_hist=slot_hist)
    return cap, 1 + n_slots * per, meta, (row_slot >= 0) & (row_pos >= 0)


def _check_out(got, ref, valid, case):
    out, ref_out = got[0].numpy(), np.asarray(ref[0])
    np.testing.assert_allclose(out[0][:, valid], ref_out[0][:, valid], atol=ATOL, rtol=RTOL,
                               err_msg=case)
    np.testing.assert_array_equal(out[0][:, ~valid], 0.0)


def test_packs_cross_the_kernel_tile():
    """Every pack is what its name says: a capacity off the 64-row tile,
    and at least one 64-row tile of the pack holding rows of 2+ slots or
    one slot's rows spilling across tiles."""
    for case, (packs, pad_blocks) in TILE_PACKS.items():
        cap, _, meta, _ = _pack(packs, pad_blocks)
        slots = meta["row_slot"]
        per_tile = [set(slots[i:i + 64][slots[i:i + 64] >= 0]) for i in range(0, cap, 64)]
        crossing = any(a & b for a, b in zip(per_tile, per_tile[1:]))
        assert cap % 64 and (max(map(len, per_tile)) >= 2 or crossing), case
    three = _pack(*TILE_PACKS["three_slots_a_tile"])[2]["row_slot"][:64]
    assert len(set(three[three >= 0])) >= 3


@pytest.mark.parametrize("impl", ["interpret", "dense"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("case", sorted(TILE_PACKS))
def test_bf16_prefill_at_tile_edges(case, group, impl):
    packs, pad_blocks = TILE_PACKS[case]
    cap, npages, meta, valid = _pack(packs, pad_blocks)
    kvh, d = 2, 16
    rng = np.random.RandomState(11 + group)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (1, kvh * group, cap, d), (1, kvh, cap, d), (1, kvh, cap, d),
        (npages, kvh, PS, d), (npages, kvh, PS, d))]
    ref = ja.ragged_prefill_attention(*(jnp.asarray(a) for a in arrays),
                                      **{k: jnp.asarray(v) for k, v in meta.items()},
                                      impl=impl, token_block=BT)
    before = dict(kernels.launch_counts)
    got = ta.ragged_prefill_attention(*(_t(a) for a in arrays),
                                      **{k: _t(v) for k, v in meta.items()}, token_block=BT)
    assert kernels.launch_counts == before  # CPU tensors: the plain version
    _check_out(got, ref, valid, case)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("case", sorted(TILE_PACKS))
def test_quant_prefill_at_tile_edges(case, group, bits):
    packs, pad_blocks = TILE_PACKS[case]
    cap, npages, meta, valid = _pack(packs, pad_blocks)
    kvh, d = 2, 32
    rng = np.random.RandomState(21 + 2 * group + bits)
    pages = []
    for _ in range(2):  # K, V: the reference's quantize_kv over normal values
        x = rng.standard_normal((npages, kvh, PS, d)).astype(np.float32)
        pages.append([np.array(a) for a in jax_quantize_kv(jnp.asarray(x), bits)])
    (kp, ks), (vp, vs) = pages
    q = rng.standard_normal((1, kvh * group, cap, d)).astype(np.float32)
    k_new = rng.standard_normal((1, kvh, cap, d)).astype(np.float32)
    v_new = rng.standard_normal((1, kvh, cap, d)).astype(np.float32)
    arrays = (q, k_new, v_new, kp, vp)
    kw = dict(meta, k_scale=ks, v_scale=vs)
    ref = ja.ragged_prefill_attention(*(jnp.asarray(a) for a in arrays),
                                      **{k: jnp.asarray(v) for k, v in kw.items()},
                                      impl="interpret", token_block=BT, kv_quant_bits=bits)
    got = ta.ragged_prefill_attention(*(_t(a) for a in arrays),
                                      **{k: _t(v) for k, v in kw.items()}, token_block=BT,
                                      kv_quant_bits=bits)
    _check_out(got, ref, valid, case)
    for pay, scl, ref_pay, ref_scl in ((got[1], got[2], ref[1], ref[2]),
                                       (got[3], got[4], ref[3], ref[4])):
        np.testing.assert_array_equal(pay.numpy(), np.asarray(ref_pay))  # every row, pads too
        np.testing.assert_array_max_ulp(scl.numpy(), np.asarray(ref_scl), maxulp=1)
