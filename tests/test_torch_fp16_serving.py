"""fp16 serving on the CPU: the fp16 entries of the paged decode (#4),
dense decode (#5) and ragged prefill (#6) kernels, and an fp16 model
served by the port's engine.

- The plain fp16 versions (``paged_decode_reference``,
  ``decode_attention_reference``, ``ragged_prefill_reference``: fp32
  scores and sums, p rounded to fp16 before the PV product, the output
  rounded to fp16; quantized K/V dequantized to fp16, q's dtype) against
  the JAX package's Pallas kernels in fp16, run as its own tests run them
  on the CPU (``impl="interpret"``): #4 at Sq 1 and 5 with GQA, 16-bit,
  int8 and int4 pages; #5 at D 128 and D 64, 16-bit, int8 and int4; #6
  over a 16-bit arena and quantized ones, with the quantize-on-write
  payloads bit for bit.
- An fp16 ``DecoderConfig.tiny`` served paged and flat by the reference's
  ``ServingEngine`` (its kernels interpreted) and by the port's, on the
  reference's weights carried across with ``models/convert.py``: equal
  greedy tokens (the smallest top-two logit gap met is printed).
- The fp16 arena's KV handoff in the reference's wire format: "float16"
  leaves, read by the reference's engine and the port's both ways.
- The wrappers' dtype routing, on meta tensors with the CUDA gate lifted
  (the checks run before any launch): bf16 goes to each kernel's entry,
  fp16 to its ``_f16`` entry, fp32 and mixed dtypes raise.

Inputs are numpy draws from a seed, rounded to fp16, handed to both
sides. Tolerances are stated where they are used.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.ops import attention as ja
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import attention as ta
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.serving.pages import wire_dtype_name

# fp16 attention outputs of |x| <~ 2: both sides round p to fp16 (2^-11
# relative) at different points of the softmax (the interpreted kernel
# rounds the unnormalised p of its online softmax, the plain version the
# normalised one) and each rounds its output to fp16 (spacing 2^-10 at
# |x| in [1, 2)): a few fp16 ulps apart at most
ATOL = 2.0 ** -9
RTOL = 2.0 ** -9
PS = 8


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


def _h(rng, *shape):
    """Standard-normal draws rounded to fp16."""
    return rng.standard_normal(shape).astype(np.float16)


def _close(got, ref):
    assert got.dtype == torch.float16 and np.asarray(ref).dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref).astype(np.float32),
                               atol=ATOL, rtol=RTOL)


def _quant(x, bits):
    """Payload and scale of fp16 K (or V) values by the reference's
    quantize_kv (identical on both sides, tests/test_torch_decode.py)."""
    pay, scale = jq.quantize_kv(_j(x), bits)
    return np.array(pay), np.array(scale)


# ---------------------------------------------------------------------------
# #4: paged decode
# ---------------------------------------------------------------------------


def _paged_case(rng, sq, h=4, kvh=2, d=32, b=4, per_slot=4):
    """Three live slots of mixed length on shuffled pages and one parked
    slot (all-parking row, positions at the end of its reservation)."""
    num_pages = 1 + (b - 1) * per_slot
    ids = 1 + rng.permutation(num_pages - 1)
    table = np.zeros((b, per_slot), np.int32)
    pos = np.zeros((b, sq), np.int32)
    for s, n in enumerate([3, PS + 1, 3 * PS - sq][: b - 1]):
        need = -(-(n + sq - 1) // PS)
        table[s, :need] = ids[s * per_slot: s * per_slot + need]
        pos[s] = n - 1 + np.arange(sq)
    pos[b - 1] = per_slot * PS - sq + np.arange(sq)
    return (_h(rng, b, h, sq, d), _h(rng, num_pages, kvh, PS, d),
            _h(rng, num_pages, kvh, PS, d), table, pos)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp16", "int8", "int4"])
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_decode_fp16_matches_reference(sq, bits):
    q, kp, vp, table, pos = _paged_case(np.random.RandomState(10 * sq + bits), sq)
    kw = {}
    if bits:
        (kp, ks), (vp, vs) = _quant(kp, bits), _quant(vp, bits)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
    ref = ja.paged_decode_attention(
        _j(q), _j(kp), _j(vp), page_table=_j(table), q_positions=_j(pos), impl="interpret",
        **{k: _j(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    got = ta.paged_decode_attention(
        _t(q), _t(kp), _t(vp), page_table=_t(table), q_positions=_t(pos),
        **{k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    _close(got, ref)


# ---------------------------------------------------------------------------
# #5: dense decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp16", "int8", "int4"])
@pytest.mark.parametrize("d", [128, 64])
def test_dense_decode_fp16_matches_reference(d, bits):
    """Per-row positions (one row at 0, one parked at L - 1), Sq 1 and 4,
    GQA group 2 at D 128, group 1 (t5-base's decode) at D 64."""
    rng = np.random.RandomState(d + bits)
    b, length = 4, 40
    h, kvh = (4, 2) if d == 128 else (3, 3)
    for sq in (1, 4):
        q, k, v = _h(rng, b, h, sq, d), _h(rng, b, kvh, length, d), _h(rng, b, kvh, length, d)
        ends = np.array([sq - 1, 12, 25, length - 1])
        pos = (ends[:, None] - sq + 1 + np.arange(sq)[None]).astype(np.int32)
        kw = {}
        if bits:
            (k, ks), (v, vs) = _quant(k, bits), _quant(v, bits)
            kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
        ref = ja.decode_attention(_j(q), _j(k), _j(v), q_positions=_j(pos), impl="interpret",
                                  **{n: _j(x) if isinstance(x, np.ndarray) else x
                                     for n, x in kw.items()})
        got = ta.decode_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                                  **{n: _t(x) if isinstance(x, np.ndarray) else x
                                     for n, x in kw.items()})
        _close(got, ref)


# ---------------------------------------------------------------------------
# #6: ragged prefill
# ---------------------------------------------------------------------------


def _packed_case(rng, packs, h=4, kvh=2, d=32, bt=8):
    """One packed grid from ``packs`` = [(hist, tail), ...] (the layout of
    tests/test_torch_paged_quant.py), fp16 q, fresh K/V and 16-bit pages."""
    n_slots = max(1, len(packs))
    cap = max(bt, sum(-(-t // bt) * bt for _, t in packs)) + bt  # and a pad block
    row_slot = np.full((cap,), -1, np.int32)
    row_pos = np.full((cap,), -1, np.int32)
    slot_hist = np.zeros((n_slots,), np.int32)
    per = max(-(-(hi + t) // PS) for hi, t in packs)
    table = np.zeros((n_slots, per), np.int32)
    r = 0
    for s, (hist, tail) in enumerate(packs):
        blocks = -(-tail // bt)
        row_slot[r:r + blocks * bt] = s
        row_pos[r:r + tail] = np.arange(hist, hist + tail)
        r += blocks * bt
        slot_hist[s] = hist
        need = -(-(hist + tail) // PS)
        table[s, :need] = 1 + s * per + np.arange(need)
    npages = 1 + n_slots * per
    arrays = [_h(rng, 1, h, cap, d), _h(rng, 1, kvh, cap, d), _h(rng, 1, kvh, cap, d),
              _h(rng, npages, kvh, PS, d), _h(rng, npages, kvh, PS, d)]
    meta = dict(page_table=table, row_slot=row_slot, row_pos=row_pos, slot_hist=slot_hist)
    return arrays, meta, (row_slot >= 0) & (row_pos >= 0)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp16", "int8", "int4"])
def test_ragged_prefill_fp16_matches_reference(bits):
    """Three slots (a 16-position arena prefix under a 21-row tail, two
    fresh tails) and a pad block. Quantized: the arena pages are payloads
    and scales; every packed row's quantize-on-write payload equals the
    reference's bit for bit, and its scale is amax / qmax exactly (the
    CUDA kernel's division: the reference's interpreted body multiplies by
    the rounded 1 / qmax, one ulp at most away, as
    tests/test_torch_paged_quant.py shows in fp32)."""
    rng = np.random.RandomState(30 + bits)
    arrays, meta, valid = _packed_case(rng, [(16, 21), (0, 7), (0, 12)])
    kw = {}
    if bits:
        (arrays[3], ks), (arrays[4], vs) = _quant(arrays[3], bits), _quant(arrays[4], bits)
        kw = dict(k_scale=ks, v_scale=vs, kv_quant_bits=bits)
    kw.update(meta)
    ref = ja.ragged_prefill_attention(
        *(_j(a) for a in arrays), impl="interpret", token_block=8,
        **{n: _j(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()})
    got = ta.ragged_prefill_attention(
        *(_t(a) for a in arrays), token_block=8,
        **{n: _t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()})
    out, ref_out = got[0], np.asarray(ref[0])
    assert out.dtype == torch.float16 and ref_out.dtype == np.float16
    np.testing.assert_allclose(out[0][:, valid].float().numpy(),
                               ref_out[0][:, valid].astype(np.float32), atol=ATOL, rtol=RTOL)
    assert not out[0][:, ~valid].any()  # pad rows exactly 0
    if not bits:
        return
    qmax = np.float32(127 if bits == 8 else 7)
    for fresh, pay, scl, ref_pay, ref_scl in ((arrays[1], got[1], got[2], ref[1], ref[2]),
                                              (arrays[2], got[3], got[4], ref[3], ref[4])):
        np.testing.assert_array_equal(pay.numpy(), np.asarray(ref_pay))
        amax = np.abs(fresh[0].astype(np.float32).transpose(1, 0, 2)).max(axis=-1,
                                                                          keepdims=True)
        np.testing.assert_array_equal(scl.numpy(), amax / qmax)
        np.testing.assert_array_max_ulp(scl.numpy(), np.asarray(ref_scl), maxulp=1)


def test_dequantize_kv_rounds_once_to_fp16():
    """dequantize_kv to fp16: payload * scale in fp32, rounded once (the
    kernels' rounding site), equal to the reference's bit for bit."""
    from accelerate_tpu_torch.utils import quantization as tq

    rng = np.random.RandomState(5)
    x = _h(rng, 3, 2, 16, 32)
    for bits in (8, 4):
        pay, scale = _quant(x, bits)
        got = tq.dequantize_kv(_t(pay), _t(scale), bits, torch.float16)
        ref = jq.dequantize_kv(_j(pay), _j(scale), bits, jnp.float16)
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        tp, ts = tq.quantize_kv(_t(x), bits)  # fp16 in: the same payloads
        np.testing.assert_array_equal(tp.numpy(), pay)
        np.testing.assert_array_equal(ts.numpy(), scale)


# ---------------------------------------------------------------------------
# an fp16 model served by both engines
# ---------------------------------------------------------------------------

ENG_KW = dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8))
NEW = 6


@pytest.fixture(scope="module")
def fp16_models():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64, dtype=jnp.float16,
                          decode_kernel="interpret", prefill_kernel="interpret")
    jmodel = JaxLM(jcfg)
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64, dtype=torch.float16)
    model = DecoderLM(cfg, device="cpu").load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 250, (n,)) for n in lengths]


def _min_gap(model, seqs, prompt_lens):
    """The smallest top-two logit gap over the generated positions of
    ``seqs`` (prompt + tokens), read from the port's cache-free forward."""
    gaps = []
    with torch.no_grad():
        for seq, n in zip(seqs, prompt_lens):
            logits = model(torch.as_tensor(seq[None, :-1], dtype=torch.long))[0, n - 1:]
            top = torch.topk(logits.float(), 2).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
    return min(gaps)


@pytest.mark.parametrize("page_size", [PS, None], ids=["paged", "flat"])
def test_fp16_engine_matches_reference(fp16_models, page_size):
    """Mixed lengths co-admitted (paged) or chunked (flat), greedy: the
    port's fp16 engine gives the reference fp16 engine's tokens."""
    jmodel, params, model = fp16_models
    prompts = _prompts(0, (5, 3, 12, 20, 8))
    kw = dict(ENG_KW, page_size=page_size)
    jeng = JaxEngine(jmodel, params, **kw)
    teng = ServingEngine(model, device="cpu", **kw)
    assert {leaf.dtype for layer in teng._arena for leaf in layer.values()
            if isinstance(leaf, torch.Tensor)} == {torch.float16}
    jreqs = [jeng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
    jeng.run()
    treqs = [teng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
    teng.run()
    gap = _min_gap(model, [t.result() for t in treqs], [p.size for p in prompts])
    print(f"fp16 {'paged' if page_size else 'flat'}: smallest top-two logit gap {gap:.4f}")
    for j, t in zip(jreqs, treqs):
        assert t.outcome == j.outcome == "finished"
        np.testing.assert_array_equal(t.result(), j.result())
    assert teng.metrics()["serving/kv_cache_bits"] == 16


def test_fp16_kv_handoff_crosses_both_ways(fp16_models):
    """An fp16 arena's handoff: "float16" leaves in the reference's wire
    format; the reference's engine imports the port's export and the
    port's the reference's, each then admits the prompt as a prefix hit
    and gives its own warm stream."""
    jmodel, params, model = fp16_models
    p = _prompts(2, (20,))[0]
    kw = dict(ENG_KW, page_size=PS)
    assert wire_dtype_name(torch.float16) == "float16"
    for src_is_port in (True, False):
        src = ServingEngine(model, device="cpu", **kw) if src_is_port else \
            JaxEngine(jmodel, params, **kw)
        dst = JaxEngine(jmodel, params, **kw) if src_is_port else \
            ServingEngine(model, device="cpu", **kw)
        src.submit(p, max_new_tokens=2, seed=0)
        src.run()
        warm = src.submit(p, max_new_tokens=NEW, seed=0)
        src.run()
        handoff = json.loads(json.dumps(src.export_prefix_kv(p)))
        assert {leaf["dtype"] for leaf in handoff["leaves"]} == {"float16"}
        assert dst.import_prefix_kv(handoff) == handoff["token_len"]
        got = dst.submit(p, max_new_tokens=NEW, seed=0)
        dst.run()
        assert got.prefix_hit == warm.prefix_hit > 0
        assert list(got.tokens) == list(warm.tokens)


# ---------------------------------------------------------------------------
# the wrappers' dtype routing
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cuda_gate(monkeypatch):
    """The wrappers' checks and plans run on meta tensors; the launch is
    recorded, not made."""
    launched = []
    monkeypatch.setattr(kernels, "_require_cuda", lambda t, name: None)
    monkeypatch.setattr(kernels, "_sm_count", lambda index: 132)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "_launch", lambda name, *args: launched.append(name))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return launched


def _meta(*shape, dtype=torch.float16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _serving_calls(dt, kv=None):
    """One call of each serving wrapper with q (and every 16-bit K/V) of
    dtype ``dt``, the 16-bit K/V of ``kv`` when given; int8 payloads and
    fp32 scales for the quantized entries."""
    kv = kv or dt
    b, h, kvh, d, pages, cap = 2, 4, 2, 128, 8, 64
    i32 = dict(dtype=torch.int32)
    table, pos = _meta(b, 4, **i32), _meta(b, 1, **i32)
    pay, scl = _meta(pages, kvh, PS, d, dtype=torch.int8), _meta(pages, kvh, PS, 1,
                                                                  dtype=torch.float32)
    rows = (_meta(b, 4, **i32), _meta(cap, **i32), _meta(cap, **i32), _meta(b, **i32))
    q1, qp = _meta(b, h, 1, d, dtype=dt), _meta(1, h, cap, d, dtype=dt)
    fresh = _meta(1, kvh, cap, d, dtype=kv)
    dense = _meta(b, kvh, 256, d, dtype=kv)
    dpay, dscl = _meta(b, kvh, 256, d, dtype=torch.int8), _meta(b, kvh, 256, 1,
                                                                dtype=torch.float32)
    return {
        "paged_decode": lambda: kernels.paged_decode(
            q1, _meta(pages, kvh, PS, d, dtype=kv), _meta(pages, kvh, PS, d, dtype=kv), table,
            pos, 0.1),
        "paged_decode_quant": lambda: kernels.paged_decode_quant(
            q1, pay, pay, scl, scl, table, pos, 0.1, 8),
        "dense_decode": lambda: kernels.dense_decode(q1, dense, dense, pos, 0.1),
        "dense_decode_quant": lambda: kernels.dense_decode_quant(
            q1, dpay, dpay, dscl, dscl, pos, 0.1, 8),
        "ragged_prefill": lambda: kernels.ragged_prefill(
            qp, fresh, fresh, _meta(pages, kvh, PS, d, dtype=kv),
            _meta(pages, kvh, PS, d, dtype=kv), *rows, 0.1, 8),
        "ragged_prefill_quant": lambda: kernels.ragged_prefill_quant(
            qp, fresh, fresh, pay, pay, scl, scl, *rows, 0.1, 8, 8),
    }


def test_serving_wrappers_route_each_dtype_to_its_entry(no_cuda_gate):
    """bf16 launches each kernel's own entry, fp16 its ``_f16`` entry (in
    the same library, counted under its own name); the ragged prefill's
    quantize workspace follows q's dtype."""
    for dt, sfx in ((torch.bfloat16, ""), (torch.float16, "_f16")):
        for name, call in _serving_calls(dt).items():
            call()
            assert no_cuda_gate[-1] == name + sfx, (name, dt)
            assert kernels.library_path(name + sfx) == kernels.library_path(name)
            assert kernels.KERNELS[name + sfx][1] == \
                kernels.KERNELS[name][1].replace("_launch", sfx + "_launch")
    assert len(no_cuda_gate) == 12


def test_serving_wrappers_raise_on_fp32_and_mixed_dtypes(no_cuda_gate):
    """fp32 q, or 16-bit K/V of another dtype than q, raise TypeError at
    the checks, before any launch."""
    for name, call in _serving_calls(torch.float32).items():
        with pytest.raises(TypeError, match="bf16 or fp16"):
            call()
    mixed = _serving_calls(torch.float16, kv=torch.bfloat16)
    for name in ("paged_decode", "dense_decode", "ragged_prefill", "ragged_prefill_quant"):
        with pytest.raises(TypeError, match="one dtype"):
            mixed[name]()
    assert no_cuda_gate == []
