"""The port's quantized paged arena (int8/int4 KV on ``page_size``)
against the JAX package on the CPU.

- ``paged_decode_attention`` with payload and scale pages: the port's
  plain version vs the reference's Pallas kernel in the interpreter
  (``impl="interpret"``), identical payloads and scales, at 1e-5 (fp32
  both sides; the two sum in other orders). Sq 1 and 4, GQA group 2, a
  parked slot, garbage in the parking page.
- ``ragged_prefill_attention`` with quantize-on-write: the port's plain
  version vs the reference's interpreted kernel on the packs of
  tests/test_prefill_kernel.py: payloads and scales bit for bit, out at
  2e-5 with pad rows exactly 0.
- ``_quantize_block`` (divide by the scale) vs ``quantize_kv`` (multiply
  by its reciprocal): each equals its reference counterpart bit for bit,
  and the two part at a .5 tie.
- The engine: the port's paged int8 / int4 engines give the JAX paged
  engine's greedy tokens exactly (the JAX engine runs its paged decode
  and ragged prefill kernels in the interpreter); flat and paged int8 are
  twins; a prefix hit reproduces the cold stream; a copy-on-write fork
  copies scales with payload; metrics and arena ratios.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.ops import attention as jatt
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.utils.quantization import quantize_kv as jax_quantize_kv
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import attention, kernels
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.pages import fork_page, init_paged_arena
from accelerate_tpu_torch.utils.quantization import quantize_kv

DECODE_TOL = 1e-5
PREFILL_TOL = 2e-5
PS = 8


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _quant_pages(rng, num_pages, kvh, ps, d, bits):
    """Payload and scale pages of standard-normal K (or V) values,
    quantized by the reference's ``quantize_kv``, as numpy."""
    x = rng.standard_normal((num_pages, kvh, ps, d)).astype(np.float32)
    pay, scale = jax_quantize_kv(jnp.asarray(x), bits)
    return np.array(pay), np.array(scale)


def _decode_case(rng, bits, sq, b=4, h=4, kvh=2, d=32, per_slot=4):
    """Slots 0..b-2 own disjoint shuffled pages; the last slot is parked
    (all-parking table row, positions at the end of its reservation).
    Table entries past a live slot's frontier point at the parking page."""
    num_pages = 1 + (b - 1) * per_slot
    kp, ks = _quant_pages(rng, num_pages, kvh, PS, d, bits)
    vp, vs = _quant_pages(rng, num_pages, kvh, PS, d, bits)
    ids = 1 + rng.permutation(num_pages - 1)
    table = np.zeros((b, per_slot), np.int32)
    pos = np.zeros((b, sq), np.int32)
    lengths = [3, PS + 1, 3 * PS - 2][: b - 1]
    for s, n in enumerate(lengths):
        need = -(-(n + sq - 1) // PS)
        table[s, :need] = ids[s * per_slot: s * per_slot + need]
        pos[s] = n - 1 + np.arange(sq)
    pos[b - 1] = per_slot * PS - sq + np.arange(sq)  # parked
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, kp, vp, ks, vs, table, pos


def _both_decode(q, kp, vp, ks, vs, table, pos, bits):
    kw = dict(kv_quant_bits=bits)
    ref = jatt.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), page_table=jnp.asarray(table),
        q_positions=jnp.asarray(pos), impl="interpret", k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), **kw)
    got = attention.paged_decode_attention(
        _t(q), _t(kp), _t(vp), page_table=_t(table), q_positions=_t(pos),
        k_scale=_t(ks), v_scale=_t(vs), **kw)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_decode_quant_matches_reference(bits, sq):
    rng = np.random.RandomState(10 * bits + sq)
    case = _decode_case(rng, bits, sq)
    got, ref = _both_decode(*case, bits)
    np.testing.assert_allclose(got, ref, atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_decode_quant_parking_garbage(bits):
    """Garbage payload and scales in the parking page: live slots (whose
    tables point past their frontier at it) do not see it, and the parked
    slot, which reads it, still agrees with the reference."""
    rng = np.random.RandomState(20 + bits)
    q, kp, vp, ks, vs, table, pos = _decode_case(rng, bits, 1)
    clean, _ = _both_decode(q, kp, vp, ks, vs, table, pos, bits)
    kp[0], vp[0] = 127, -127
    ks[0], vs[0] = 3.0, 2.5
    got, ref = _both_decode(q, kp, vp, ks, vs, table, pos, bits)
    np.testing.assert_array_equal(got[:-1], clean[:-1])
    np.testing.assert_allclose(got, ref, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_paged_decode_quant_requires_scales():
    q = torch.zeros((1, 2, 1, 16))
    pages = torch.zeros((2, 1, PS, 16), dtype=torch.int8)
    table = torch.zeros((1, 1), dtype=torch.int32)
    pos = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        attention.paged_decode_attention(q, pages, pages, page_table=table,
                                         q_positions=pos, kv_quant_bits=8)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        attention.ragged_prefill_attention(
            torch.zeros((1, 2, 8, 16)), torch.zeros((1, 1, 8, 16)), torch.zeros((1, 1, 8, 16)),
            pages, pages, page_table=table, row_slot=pos[0].repeat(8),
            row_pos=pos[0].repeat(8), slot_hist=pos[0], kv_quant_bits=4)


def _packed_case(rng, packs, bits, *, h=4, kvh=2, d=32, ps=PS, bt=8):
    """numpy copy of tests/test_prefill_kernel.py's ``_packed_case``: one
    packed grid from ``packs`` = [(hist, tail), ...], rows of one slot
    contiguous and position-ordered, each pack padded to a token-block
    boundary (pads keep the slot id, pos -1), per-slot tables over
    disjoint live pages (page 0 parked), int8 payload pages and scales."""
    n_slots = max(1, len(packs))
    cap = max(bt, sum(-(-t // bt) * bt for _, t in packs))
    row_slot = np.full((cap,), -1, np.int32)
    row_pos = np.full((cap,), -1, np.int32)
    slot_hist = np.zeros((n_slots,), np.int32)
    per = max(1, max((-(-(hi + t) // ps) for hi, t in packs), default=1))
    table = np.zeros((n_slots, per), np.int32)
    r = 0
    for s, (hist, tail) in enumerate(packs):
        blocks = -(-tail // bt)
        row_slot[r:r + blocks * bt] = s
        row_pos[r:r + tail] = np.arange(hist, hist + tail)
        r += blocks * bt
        slot_hist[s] = hist
        need = -(-(hist + tail) // ps)
        table[s, :need] = 1 + s * per + np.arange(need)
    npages = 1 + n_slots * per
    kp, ks = _quant_pages(rng, npages, kvh, ps, d, bits)
    vp, vs = _quant_pages(rng, npages, kvh, ps, d, bits)
    q = rng.standard_normal((1, h, cap, d)).astype(np.float32)
    k_new = rng.standard_normal((1, kvh, cap, d)).astype(np.float32)
    v_new = rng.standard_normal((1, kvh, cap, d)).astype(np.float32)
    arrays = (q, k_new, v_new, kp, vp)
    kw = dict(page_table=table, row_slot=row_slot, row_pos=row_pos, slot_hist=slot_hist,
              token_block=bt, k_scale=ks, v_scale=vs, kv_quant_bits=bits)
    return arrays, kw, (row_slot >= 0) & (row_pos >= 0)


PACKS = {
    "mixed 75/25": [(16, 21), (0, 7), (0, 8), (0, 5)],
    "hist 7": [(7, 8)],
    "hist 8": [(8, 8)],
    "hist 9": [(9, 8)],
    "all-pad grid": [],
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_ragged_prefill_quant_matches_reference(pack, bits):
    rng = np.random.RandomState(len(pack) + bits)
    arrays, kw, valid = _packed_case(rng, PACKS[pack], bits)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = jatt.ragged_prefill_attention(*(jnp.asarray(a) for a in arrays), impl="interpret",
                                        **jkw)
    got = attention.ragged_prefill_attention(*(_t(a) for a in arrays), **tkw)
    out, ref_out = got[0].numpy(), np.asarray(ref[0])
    np.testing.assert_allclose(out[0][:, valid], ref_out[0][:, valid], atol=PREFILL_TOL,
                               rtol=PREFILL_TOL)
    assert not np.any(out[0][:, ~valid])  # pad rows exactly 0
    qmax = np.float32(127 if bits == 8 else 7)
    for fresh, pay, scl, ref_pay, ref_scl in ((arrays[1], got[1], got[2], ref[1], ref[2]),
                                              (arrays[2], got[3], got[4], ref[3], ref[4])):
        np.testing.assert_array_equal(pay.numpy(), np.asarray(ref_pay))  # every row, pads too
        amax = np.abs(fresh[0].transpose(1, 0, 2)).max(axis=-1, keepdims=True)
        # the port's scale is amax / qmax, as written in _quantize_block.
        # XLA, compiling the interpreted kernel body, turns the division by
        # the constant qmax into a product with its rounded reciprocal:
        # the reference's scales are that product, at most one ulp away
        np.testing.assert_array_equal(scl.numpy(), amax / qmax)
        np.testing.assert_array_equal(np.asarray(ref_scl), amax * (np.float32(1) / qmax))
        np.testing.assert_array_max_ulp(scl.numpy(), np.asarray(ref_scl), maxulp=1)


def _tie_rows(bits):
    """A row [amax, x, -x, 0] x 4 where x / scale lies within an ulp of a
    .5 tie and rounds one way divided, the other multiplied by 1 / scale
    (found by search, fixed here)."""
    amax, x = {8: (2.4070911, -2.2080798), 4: (3.3031876, -1.1797099)}[bits]
    return np.array([[amax, x, -x, 0.0] * 4], np.float32)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_block_divides_where_quantize_kv_multiplies(bits):
    rng = np.random.RandomState(bits)
    rows = np.concatenate([_tie_rows(bits), rng.standard_normal((6, 16)).astype(np.float32),
                           np.zeros((1, 16), np.float32)])
    got = attention._quantize_block(_t(rows), bits)
    ref = jatt._quantize_block(jnp.asarray(rows), bits)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    kv_pay, kv_scale = quantize_kv(_t(rows), bits)
    ref_pay, ref_scale = jax_quantize_kv(jnp.asarray(rows), bits)
    np.testing.assert_array_equal(kv_pay.numpy(), np.asarray(ref_pay))
    np.testing.assert_array_equal(kv_scale.numpy(), got[1].numpy())  # same scale
    # at the tie the two expressions part by one payload step; elsewhere
    # (random rows, the zero row) they agree
    assert not torch.equal(kv_pay[0], got[0][0])
    torch.testing.assert_close(kv_pay[1:], got[0][1:], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENG_KW = dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=PS)
NEW = 6


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64,
                          decode_kernel="interpret", prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"]
    )
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 250, (n,)) for n in lengths]


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "int4"])
def test_quant_paged_engine_matches_reference(models, kv_cache_dtype):
    """Mixed lengths co-admitted into packs, a 20-token prompt continuing
    mid-tail over its own quantized prefix, and a prompt that shares a
    16-token prefix with an earlier one (a prefix hit on quantized pages,
    then a copy-on-write fork)."""
    jmodel, params, model = models
    prompts = _prompts(0, (5, 3, 12, 20, 8))
    prompts.append(np.concatenate([prompts[3][:16], [7, 9, 11]]))
    jeng = JaxEngine(jmodel, params, kv_cache_dtype=kv_cache_dtype, **ENG_KW)
    teng = ServingEngine(model, device="cpu", kv_cache_dtype=kv_cache_dtype, **ENG_KW)
    jreqs = [jeng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
    jeng.run()
    treqs = [teng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.outcome == j.outcome == "finished"
        np.testing.assert_array_equal(t.result(), j.result())
        assert t.prefix_hit == j.prefix_hit
    assert treqs[-1].prefix_hit == 16 and treqs[3].prefill_dispatches >= 3
    bits = {"int8": 8, "int4": 4}[kv_cache_dtype]
    assert teng.metrics()["serving/kv_cache_bits"] == bits
    assert jeng.metrics()["serving/kv_cache_bits"] == bits


def test_flat_and_paged_int8_are_twins(models):
    _, _, model = models
    prompts = _prompts(1, (5, 8, 12, 3))
    paged = ServingEngine(model, device="cpu", kv_cache_dtype="int8", **ENG_KW)
    flat = ServingEngine(model, device="cpu", kv_cache_dtype="int8",
                         **{**ENG_KW, "page_size": None})
    for a, b in zip(paged.generate_batched(prompts, max_new_tokens=NEW),
                    flat.generate_batched(prompts, max_new_tokens=NEW)):
        np.testing.assert_array_equal(a, b)
    assert paged.metrics()["serving/kv_cache_bits"] == flat.metrics()["serving/kv_cache_bits"] == 8


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "int4"])
def test_prefix_hit_reproduces_cold_stream(models, kv_cache_dtype):
    """A hit maps the quantized pages and scales as they are: the hit
    stream equals the cold one, and its first decode write forks the
    shared boundary page."""
    _, _, model = models
    engine = ServingEngine(model, device="cpu", kv_cache_dtype=kv_cache_dtype,
                           **{**ENG_KW, "num_slots": 1})
    prompt = _prompts(2, (12,))[0]
    cold = engine.submit(prompt, max_new_tokens=NEW)
    engine.run()
    hit = engine.submit(prompt, max_new_tokens=NEW)
    engine.run()
    assert hit.prefix_hit >= PS
    assert engine.page_forks > 0
    np.testing.assert_array_equal(cold.result(), hit.result())


def test_fork_copies_scales_with_payload():
    cfg = DecoderConfig.tiny(num_kv_heads=2)
    arena = init_paged_arena(cfg, 4, PS, torch.device("cpu"), "int4")
    assert set(arena[0]) == {"k", "v", "k_scale", "v_scale"}
    assert arena[0]["k"].shape == (4, 2, PS, cfg.head_dim // 2)
    assert arena[0]["k_scale"].shape == (4, 2, PS, 1)
    gen = torch.Generator().manual_seed(0)
    for layer in arena:
        for name, leaf in layer.items():
            if leaf.dtype == torch.int8:
                leaf[2] = torch.randint(-128, 128, leaf[2].shape, generator=gen,
                                        dtype=torch.int8)
            else:
                leaf[2] = torch.rand(leaf[2].shape, generator=gen)
    fork_page(arena, 2, 3)
    for layer in arena:
        for leaf in layer.values():
            assert torch.equal(leaf[3], leaf[2])


def test_arena_shrinks_with_bits(models):
    _, _, model = models
    sizes = {kv: ServingEngine(model, device="cpu", kv_cache_dtype=kv, **ENG_KW).arena_bytes
             for kv in ("bf16", "int8", "int4")}
    assert sizes["bf16"] / sizes["int8"] >= 1.8, sizes
    assert sizes["int8"] / sizes["int4"] >= 1.3, sizes
    assert sizes["bf16"] / sizes["int4"] >= 3.0, sizes
    m = ServingEngine(model, device="cpu", **ENG_KW).metrics()
    assert m["serving/kv_cache_bits"] == 16


def test_quant_wrappers_refuse_other_bits():
    """The quantized wrappers take 8 or 4 bits and nothing else, on any
    device (their CPU routing is held by tests/test_torch_package.py)."""
    rng = np.random.RandomState(3)
    q, kp, vp, ks, vs, table, pos = (_t(a) for a in _decode_case(rng, 8, 1))
    with pytest.raises(ValueError, match="8 or 4"):
        kernels.paged_decode_quant(q, kp, vp, ks, vs, table, pos, 0.25, 6)
    arrays, kw, _ = _packed_case(rng, [(5, 9)], 8)
    args = [_t(a) for a in arrays] + [_t(kw[k]) for k in ("k_scale", "v_scale", "page_table",
                                                         "row_slot", "row_pos", "slot_hist")]
    with pytest.raises(ValueError, match="8 or 4"):
        kernels.ragged_prefill_quant(*args, 0.25, 8, 2)
