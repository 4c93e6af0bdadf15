"""The dense decode kernel's split kv walk, held on the CPU.

The CUDA kernels (csrc/dense_decode.cu, dense_decode_quant.cu) run the
paged decode kernel's core (csrc/decode_common.cuh) through a dense row
addressing: position p of batch row b and kv head h is row
(b * KVH + h) * L + p, a tile past L reads row L - 1 again, and every
row's position is bounded to L - 1, so a row at or past L attends each
of the L positions once. Each batch row's kv walk is cut into runs of
whole 64-token tiles, one partial (m, l, acc) a split, merged in a second
pass. They run only on the card; here:

- (a) the port's ``decode_attention`` (its plain version on a CPU tensor)
  against the JAX package's (``impl="interpret"``, the Pallas kernel in
  the interpreter, and ``impl="dense"``) at the new kernel's edges:
  position 0, 63 / 64 / 65, a split length +- 1, a row parked at L - 1,
  rows at or past L, L 256, L 130 (not a multiple of 64) and L 133 (not
  a multiple of 4), Sq 1 / 4 / 16, GQA groups 1 and 2, fp32, int8 and
  int4 (payloads from the reference's ``quantize_kv``). The reference's
  interpreter picks its kv block from L's divisors
  (``_pick_decode_block``): block 2 at L 130 and block 1 at L 133, so
  those cases keep to few batch rows and two kv heads to stay quick;
- (b) ``merge_decode_partials`` (the merge pass's plain version) over the
  plain partials of each row's live splits, cut at
  ``decode_split_ranges`` from the max position bounded to L - 1 (as the
  split kernel and the merge pass both count them), equals the JAX
  package's read, rows past L included;
- (c) the split plan at the dense paths' shapes covers every position of
  the arena once;
- (d) the dense wrappers' gate (``_decode_rows_check``): what they refuse
  and the model shapes they take.

Inputs are numpy from a seed, handed to both sides; fp32 compared at 1e-5
(the two sides sum in other orders).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops import attention as jatt
from accelerate_tpu.utils.quantization import quantize_kv as jax_quantize_kv
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.ops import attention, kernels
from accelerate_tpu_torch.utils.quantization import dequantize_kv

TOL = 1e-5
D = 64
KVH = 2
SMS = 4  # an SM count that gives the L 256 shapes two-tile splits


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _split_len(b, length):
    per_split, _ = kernels.decode_split_plan(b, KVH, length, SMS)
    return per_split * kernels.DECODE_TILE


def _lasts(length, split):
    """The last query position of each edge row: position 0, a tile edge
    +- 1, a split edge +- 1, a row parked at L - 1 and one past L (rows
    that coincide at small L are kept once)."""
    return list(dict.fromkeys([0, 63, 64, 65, split - 1, split, split + 1, length - 1,
                               length + 3]))


def _positions(lasts, sq):
    """[B, Sq]: each row queries its last Sq positions, from 0."""
    return np.stack([np.maximum(np.arange(last - sq + 1, last + 1), 0) for last in lasts]
                    ).astype(np.int32)


def _case(rng, length, sq, group, bits, lasts=None):
    """Numpy inputs of one dense decode call over the edge rows of a
    [B, KVH, L, D] arena: ``(q, k, v, k_scale, v_scale, pos)``."""
    if lasts is None:
        lasts = _lasts(length, _split_len(9, length))
    pos = _positions(lasts, sq)
    b = pos.shape[0]
    q = rng.standard_normal((b, KVH * group, sq, D)).astype(np.float32)
    kv = [rng.standard_normal((b, KVH, length, D)).astype(np.float32) for _ in range(2)]
    scales = [None, None]
    if bits:
        for i in range(2):
            pay, scl = jax_quantize_kv(jnp.asarray(kv[i]), bits)
            kv[i], scales[i] = np.array(pay), np.array(scl)
    return q, kv[0], kv[1], scales[0], scales[1], pos


def _port(q, k, v, ks, vs, pos, bits):
    kw = dict(k_scale=_t(ks), v_scale=_t(vs), kv_quant_bits=bits) if bits else {}
    return attention.decode_attention(_t(q), _t(k), _t(v), q_positions=_t(pos), **kw).numpy()


def _reference(q, k, v, ks, vs, pos, bits, impl):
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_quant_bits=bits) if bits else {}
    return np.asarray(jatt.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(pos),
        impl=impl, **kw))


# (L, Sq, group, bits): every arena type at Sq 1 on the L 256 arena, Sq 4
# and Sq 16 at groups 1 and 2; L 130 and L 133 (the interpreter's blocks
# 2 and 1) in each arena type
EDGE_CASES = [(256, 1, 2, bits) for bits in (0, 8, 4)] + [
    (256, 4, 2, 0), (256, 4, 1, 8), (256, 16, 2, 4), (256, 16, 1, 0), (256, 1, 1, 4),
    (130, 1, 2, 0), (130, 4, 2, 8), (130, 1, 1, 4),
    (133, 1, 2, 4), (133, 4, 1, 0), (133, 16, 2, 8),
]


@pytest.mark.parametrize("length,sq,group,bits", EDGE_CASES)
def test_dense_decode_at_split_edges(length, sq, group, bits):
    rng = np.random.RandomState(length + 100 * sq + 10 * group + bits)
    case = _case(rng, length, sq, group, bits)
    assert (case[-1] >= length).any() and (case[-1][:, -1] == length - 1).any()
    got = _port(*case, bits)
    assert np.isfinite(got).all()
    for impl in ("interpret", "dense"):
        np.testing.assert_allclose(got, _reference(*case, bits, impl), atol=TOL, rtol=TOL,
                                   err_msg=f"vs impl={impl}")


@pytest.mark.parametrize("length", [256, 130, 133])
def test_split_length_edges_are_tile_multiples(length):
    """The split the edge rows aim at is two whole tiles for the batch the
    cases have, so rows at split - 1 / split + 1 sit on both sides of a
    split edge that is not also the first tile edge."""
    b = len(_lasts(length, _split_len(9, length)))
    assert _split_len(9, length) == _split_len(b, length) == 2 * kernels.DECODE_TILE


def _dense_kv(k, v, ks, vs, bits):
    if not bits:
        return _t(k), _t(v)
    return (dequantize_kv(_t(k), _t(ks), bits, torch.float32),
            dequantize_kv(_t(v), _t(vs), bits, torch.float32))


@pytest.mark.parametrize("length,sq,group,bits", [
    (256, 1, 2, 0), (256, 4, 2, 8), (256, 16, 1, 4), (130, 4, 1, 0), (133, 1, 2, 8),
    (133, 4, 2, 4),
])
def test_merge_of_bounded_split_partials_matches_reference(length, sq, group, bits):
    """Cut each batch row's kv walk at its live splits, counted from
    min(max position, L - 1) as the kernels count them, take the plain
    partial of each split, merge with merge_decode_partials, and compare
    with the JAX package's read. Rows past L attend all L positions;
    rows whose position lies before a split attend nothing there (m =
    -inf, zero weight, no NaN)."""
    rng = np.random.RandomState(70 + length + 10 * sq + group + bits)
    q, k, v, ks, vs, pos = _case(rng, length, sq, group, bits)
    kt, vt = _dense_kv(k, v, ks, vs, bits)
    qt, post = _t(q), _t(pos)
    sm_scale = 1.0 / np.sqrt(D)
    per_split = _split_len(pos.shape[0], length) // kernels.DECODE_TILE
    _, n_splits = kernels.decode_split_plan(pos.shape[0], KVH, length, SMS)
    ref = _reference(q, k, v, ks, vs, pos, bits, "dense")
    empty_rows = 0
    for s in range(pos.shape[0]):
        ranges = kernels.decode_split_ranges(min(int(pos[s].max()), length - 1), per_split)
        assert len(ranges) <= n_splits  # every live split has a block
        parts = [attention.decode_partial_reference(qt[s:s + 1], kt[s:s + 1], vt[s:s + 1],
                                                    post[s:s + 1], lo, hi, sm_scale)
                 for lo, hi in ranges]
        m, l, acc = (torch.stack([p[i] for p in parts]) for i in range(3))
        empty = torch.isinf(m)
        empty_rows += int(empty.sum())
        assert not torch.isnan(m).any() and (l[empty] == 0).all() and (acc[empty] == 0).all()
        got = attention.merge_decode_partials(m, l, acc)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref[s:s + 1], atol=TOL, rtol=TOL)
    if sq > 1:  # rows whose position lies before their batch row's last split
        assert empty_rows > 0


@pytest.mark.parametrize("b,kvh,length,sms", [
    (9, 8, 2048, 132), (8, 8, 2048, 132), (1, 32, 768, 132), (4, 32, 768, 132),
    (8, 8, 1000, 132), (4, 8, 1001, 132), (6, 2, 133, 4), (1, 1, 1, 132),
])
def test_dense_split_plan_covers_the_arena_once(b, kvh, length, sms):
    """The flat engine's (B 9, KVH 8, L 2048) and generate()'s (llama_7b,
    KVH 32, L 768) shapes and the chip run's odd lengths: the splits
    together cover every position of the arena once, and the live splits
    of any max position (bounded to L - 1) are a prefix of them."""
    per_split, n_splits = kernels.decode_split_plan(b, kvh, length, sms)
    tile = kernels.DECODE_TILE
    assert 1 <= per_split <= kernels.DECODE_MAX_SPLIT_TILES
    assert n_splits * per_split * tile >= length > (n_splits - 1) * per_split * tile
    for max_pos in sorted({0, tile - 1, tile, length - 1, length, 2 * length + 5}):
        ranges = kernels.decode_split_ranges(min(max_pos, length - 1), per_split)
        assert 1 <= len(ranges) <= n_splits
        covered = [p for lo, hi in ranges for p in range(lo, hi) if p < length]
        assert covered == list(range(len(covered)))  # contiguous from 0, each once
        assert covered[-1] >= min(max_pos, length - 1)


def test_dense_split_plan_at_the_chip_shapes():
    """The flat arena (B 9, KVH 8, L 2048) takes 3 tiles a split and 11
    splits on an H100's 132 SMs; generate() at B 1 on llama_7b (KVH 32,
    L 768) one tile a split and 12 splits, 9 of them live at position
    575."""
    assert kernels.decode_split_plan(9, 8, 2048, 132) == (3, 11)
    assert kernels.decode_split_plan(1, 32, 768, 132) == (1, 12)
    assert len(kernels.decode_split_ranges(575, 1)) == 9


@pytest.mark.parametrize("h,sq,d,kvh,msg", [
    (16, 1, 96, 8, "head_dim 96"),
    (16, 1, 32, 8, "head_dim 32"),
    (16, 17, 128, 8, "1..16 query rows"),
    (16, 0, 128, 8, "1..16 query rows"),
    (64, 16, 128, 8, "128 query rows"),
    (40, 16, 128, 8, "80 query rows"),
    (12, 1, 128, 8, "do not group"),
])
def test_dense_decode_gate_refuses(h, sq, d, kvh, msg):
    with pytest.raises(ValueError, match=msg):
        kernels._decode_rows_check(h, sq, d, kvh, "dense decode")


@pytest.mark.parametrize("cfg", ["small_1b", "llama_7b"])
def test_dense_decode_gate_takes_the_model_shapes(cfg):
    """Both models' decode step (Sq 1), the Sq 4 case and every Sq up to
    16 pass: small_1b's group 2 reaches R 32, llama_7b's group 1 R 16."""
    c = getattr(DecoderConfig, cfg)()
    for sq in range(1, attention.DECODE_KERNEL_MAX_SQ + 1):
        group = kernels._decode_rows_check(c.num_heads, sq, c.head_dim, c.num_kv_heads,
                                           "dense decode")
        assert group * sq <= attention.DECODE_KERNEL_MAX_ROWS


def test_dense_wrappers_take_cpu_tensors_to_the_plain_version():
    """Shapes the kernels refuse (R 128 here) still run on a CPU tensor:
    the gate stands only in front of a launch."""
    rng = np.random.RandomState(3)
    q, k, v, _, _, pos = _case(rng, 130, 16, 4, 0, lasts=[20, 129])
    q = np.concatenate([q, q], axis=1)  # group 8 at Sq 16: R 128
    got = kernels.dense_decode(_t(q), _t(k), _t(v), _t(pos), 1.0 / np.sqrt(D))
    want = attention.decode_attention_reference(_t(q), _t(k), _t(v), _t(pos), 1.0 / np.sqrt(D))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
