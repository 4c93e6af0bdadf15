"""The paged decode kernel's split kv walk, held on the CPU.

The CUDA kernels (csrc/decode_common.cuh) split each slot's kv walk into
runs of whole 64-token tiles, write one partial (m, l, acc) per split and
merge them in a second pass. They run only on the card; here:

- (a) the port's plain ``paged_decode_attention`` against the JAX
  package's (``impl="interpret"``, the Pallas kernel in the interpreter,
  and ``impl="dense"``) at the new kernel's edges: lengths 1, 64, 65 and a
  split length +- 1, verify rows that straddle a split and a page edge, a
  parked slot, Sq 1 / 5 / 16, GQA groups 1 and 2, page sizes 8 / 16 / 32,
  bf16 (fp32 here), int8 and int4 (payloads from the reference's
  ``quantize_kv``);
- (b) ``merge_decode_partials`` (the merge pass's plain version) over the
  plain partials of the live splits equals the JAX package's read, with
  rows that attend nothing in a split (no NaN, zero weight);
- (c) the wrapper's split plan: every live position of every slot lies in
  exactly one split of whole tiles, and the main serving shape fills the
  card;
- (d) ``_decode_kernel_check``: what the kernels refuse and the serving
  shapes they take.

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

TOL = 1e-5
D = 64
CAP = 256  # positions a slot's page table reserves
SMS = 4    # an SM count that gives the test shapes two-tile splits


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _split_len(b, kvh):
    per_split, _ = kernels.decode_split_plan(b, kvh, CAP, SMS)
    return per_split * kernels.DECODE_TILE


def _case(rng, rows, ps, group, bits, kvh=2):
    """One paged decode call: ``rows[s]`` is slot s's query positions
    ([Sq] each; None: a parked slot querying the last position of its
    reservation on every row, on an all-parking table row). Live slots own
    disjoint shuffled pages; table entries past a live slot's frontier
    point at the parking page 0. Returns the numpy inputs."""
    sq = len(next(r for r in rows if r is not None))
    b, p_per_slot = len(rows), CAP // ps
    need = [0 if r is None else max(r) // ps + 1 for r in rows]
    num_pages = 1 + sum(need)
    ids = 1 + rng.permutation(num_pages - 1)
    table = np.zeros((b, p_per_slot), np.int32)
    pos = np.full((b, sq), CAP - 1, np.int32)
    at = 0
    for s, r in enumerate(rows):
        if r is not None:
            table[s, : need[s]] = ids[at: at + need[s]]
            at += need[s]
            pos[s] = r
    q = rng.standard_normal((b, kvh * group, sq, D)).astype(np.float32)
    kv = [rng.standard_normal((num_pages, kvh, ps, D)).astype(np.float32) for _ in range(2)]
    scales = [None, None]
    if bits:
        for i in range(2):
            pay, scl = jax_quantize_kv(jnp.asarray(kv[i]), bits)
            kv[i], scales[i] = np.array(pay), np.array(scl)
    return q, kv[0], kv[1], scales[0], scales[1], table, pos


def _port(q, kp, vp, ks, vs, table, pos, bits):
    kw = dict(k_scale=_t(ks), v_scale=_t(vs), kv_quant_bits=bits) if bits else {}
    return attention.paged_decode_attention(
        _t(q), _t(kp), _t(vp), page_table=_t(table), q_positions=_t(pos), **kw).numpy()


def _reference(q, kp, vp, ks, vs, table, pos, bits, impl):
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_quant_bits=bits) if bits else {}
    return np.asarray(jatt.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), page_table=jnp.asarray(table),
        q_positions=jnp.asarray(pos), impl=impl, **kw))


def _decode_rows(sq, split):
    """Query positions of the edge slots, Sq ``sq`` each: a slot at
    position 0 (Sq 1) or its first rows, slots whose last row sits at 63,
    64 (a tile edge) and split - 2 .. split (a split edge), rows that
    straddle the split edge and a page edge, and a parked slot."""
    def run(last):
        return [max(last - sq + 1 + t, 0) for t in range(sq)] if sq > 1 else [last]

    rows = [run(0), run(63), run(64), run(split - 2), run(split - 1), run(split)]
    if sq > 1:  # rows that straddle the split edge, and a page edge at 16
        rows += [[split - sq // 2 + t for t in range(sq)], [16 - sq // 2 + t for t in range(sq)]]
    return rows + [None]


# (Sq, group, page size, bits): every page size and arena type at Sq 1
# and at the verify step's Sq 5, Sq 16 (R 32 at group 2), group 1
EDGE_CASES = [(1, 2, ps, bits) for ps in (8, 16, 32) for bits in (0, 8, 4)] + [
    (5, 2, 16, 0), (5, 2, 8, 8), (5, 2, 32, 4),
    (5, 1, 16, 0), (5, 1, 16, 8), (1, 1, 8, 4),
    (16, 2, 16, 0), (16, 2, 32, 8), (16, 1, 8, 4),
]


@pytest.mark.parametrize("sq,group,ps,bits", EDGE_CASES)
def test_paged_decode_at_split_edges(sq, group, ps, bits):
    rng = np.random.RandomState(1000 * sq + 100 * group + ps + bits)
    rows = _decode_rows(sq, _split_len(9, 2))
    case = _case(rng, rows, ps, group, bits)
    got = _port(*case, bits)
    assert np.isfinite(got).all()
    for impl in ("interpret", "dense"):
        np.testing.assert_allclose(got, _reference(*case, bits, impl), atol=TOL, rtol=TOL,
                                   err_msg=f"vs impl={impl}")


def test_split_length_edges_are_tile_multiples():
    """The split the edge cases aim at is two whole tiles here, so the
    cases' rows at split - 1 / split sit on both sides of a split edge
    that is not also the first tile edge."""
    assert _split_len(9, 2) == 2 * kernels.DECODE_TILE


def _partials(q, k, v, pos, ranges, sm_scale):
    parts = [attention.decode_partial_reference(q, k, v, pos, lo, hi, sm_scale)
             for lo, hi in ranges]
    return [torch.stack([p[i] for p in parts]) for i in range(3)]


@pytest.mark.parametrize("sq,group,bits", [(1, 2, 0), (5, 2, 0), (5, 1, 8), (16, 2, 4)])
def test_merge_of_split_partials_matches_reference(sq, group, bits):
    """Split the plain masked-dense read over each slot's live split
    ranges (the kernel's plan), merge with merge_decode_partials, and
    compare with the JAX package's paged read. Rows that attend nothing
    in a split (verify rows whose position lies before it) get m = -inf
    there and weigh exactly 0."""
    rng = np.random.RandomState(50 + 10 * sq + group + bits)
    split = _split_len(9, 2)
    rows = _decode_rows(sq, split)
    q, kp, vp, ks, vs, table, pos = _case(rng, rows, 16, group, bits)
    k = attention.gather_kv_pages(_t(kp), _t(table))
    v = attention.gather_kv_pages(_t(vp), _t(table))
    if bits:
        from accelerate_tpu_torch.utils.quantization import dequantize_kv

        k = dequantize_kv(k, attention.gather_kv_pages(_t(ks), _t(table)), bits, torch.float32)
        v = dequantize_kv(v, attention.gather_kv_pages(_t(vs), _t(table)), bits, torch.float32)
    qt, post = _t(q), _t(pos)
    sm_scale = 1.0 / np.sqrt(D)
    per_split = split // kernels.DECODE_TILE
    ref = _reference(q, kp, vp, ks, vs, table, pos, bits, "dense")
    empty_rows = 0
    for s in range(len(rows)):
        ranges = kernels.decode_split_ranges(int(pos[s].max()), per_split)
        m, l, acc = _partials(qt[s:s + 1], k[s:s + 1], v[s:s + 1], post[s:s + 1], ranges,
                              sm_scale)
        empty = torch.isinf(m)
        empty_rows += int(empty.sum())
        assert not torch.isnan(m).any() and (l[empty] == 0).all() and (acc[empty] == 0).all()
        got = attention.merge_decode_partials(m, l, acc)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref[s:s + 1], atol=TOL, rtol=TOL)
    if sq > 1:  # verify rows whose position lies before their slot's last split
        assert empty_rows > 0


def test_merge_weighs_empty_partials_zero():
    """A partial with m = -inf (any l, acc) changes nothing; a row with no
    weight at all gives 0, not NaN."""
    rng = np.random.RandomState(7)
    m = _t(rng.standard_normal((3, 2, 4)).astype(np.float32))
    l = _t(rng.uniform(0.5, 2.0, (3, 2, 4)).astype(np.float32))
    acc = _t(rng.standard_normal((3, 2, 4, 8)).astype(np.float32))
    base = attention.merge_decode_partials(m, l, acc)
    m2 = torch.cat([m, torch.full((1, 2, 4), float("-inf"))])
    l2 = torch.cat([l, torch.zeros((1, 2, 4))])
    acc2 = torch.cat([acc, torch.zeros((1, 2, 4, 8))])
    np.testing.assert_array_equal(attention.merge_decode_partials(m2, l2, acc2).numpy(),
                                  base.numpy())
    none = attention.merge_decode_partials(torch.full((2, 1, 1), float("-inf")),
                                           torch.zeros((2, 1, 1)), torch.zeros((2, 1, 1, 8)))
    np.testing.assert_array_equal(none.numpy(), np.zeros((1, 1, 8), np.float32))


@pytest.mark.parametrize("b,kvh,capacity,sms", [
    (9, 8, 2048, 132), (8, 8, 2048, 132), (1, 8, 2048, 132), (1, 32, 768, 132),
    (4, 32, 768, 132), (64, 8, 4096, 132), (2, 2, 256, 2), (3, 1, 100, 7),
    (1, 1, 65536, 132), (16, 4, 8192, 114),
])
def test_split_plan_covers_every_position_once(b, kvh, capacity, sms):
    per_split, n_splits = kernels.decode_split_plan(b, kvh, capacity, sms)
    tile = kernels.DECODE_TILE
    assert 1 <= per_split <= kernels.DECODE_MAX_SPLIT_TILES
    assert n_splits * per_split * tile >= capacity > (n_splits - 1) * per_split * tile
    rng = np.random.RandomState(capacity + sms)
    for max_pos in sorted({0, 1, tile - 1, tile, capacity - 1,
                           *rng.randint(0, capacity, 20).tolist()}):
        ranges = kernels.decode_split_ranges(max_pos, per_split)
        assert len(ranges) <= n_splits
        assert ranges[0][0] == 0 and ranges[-1][1] > max_pos
        for (lo, hi), nxt in zip(ranges, ranges[1:] + [None]):
            assert lo % tile == 0 and hi - lo == per_split * tile
            assert nxt is None or nxt[0] == hi  # contiguous: each position once
        assert ranges[-1][0] <= max_pos  # no split past the live range


def test_split_plan_fills_the_card_on_the_serving_shape():
    """chip_smoke.py's paged decode shape (9 slots x 8 kv heads, lengths
    17..1500 plus one parked at 2047, capacity 2048) on an H100's 132 SMs:
    at least two live blocks per SM."""
    per_split, _ = kernels.decode_split_plan(9, 8, 2048, 132)
    last = [16, 129, 255, 510, 699, 1023, 1299, 1499, 2047]
    live = 8 * sum(len(kernels.decode_split_ranges(p, per_split)) for p in last)
    assert live >= 2 * 132


@pytest.mark.parametrize("h,sq,d,kvh,ps,msg", [
    (16, 1, 32, 8, 16, "head_dim 32"),
    (16, 1, 96, 8, 16, "head_dim 96"),
    (16, 1, 128, 8, 12, "page size 12"),
    (16, 1, 128, 8, 4, "page size 4"),
    (16, 17, 128, 8, 16, "1..16 query rows"),
    (16, 0, 128, 8, 16, "1..16 query rows"),
    (64, 16, 128, 8, 16, "128 query rows"),
    (40, 16, 128, 8, 16, "80 query rows"),
    (12, 1, 128, 8, 16, "do not group"),
])
def test_decode_kernel_check_refuses(h, sq, d, kvh, ps, msg):
    with pytest.raises(ValueError, match=msg):
        kernels._decode_kernel_check(h, sq, d, kvh, ps)


@pytest.mark.parametrize("cfg", ["small_1b", "llama_7b"])
def test_decode_kernel_check_takes_the_serving_shapes(cfg):
    c = getattr(DecoderConfig, cfg)()
    for sq in range(1, attention.DECODE_KERNEL_MAX_SQ + 1):
        for ps in (8, 16, 32):
            group = kernels._decode_kernel_check(c.num_heads, sq, c.head_dim, c.num_kv_heads, ps)
            assert group * sq <= attention.DECODE_KERNEL_MAX_ROWS
