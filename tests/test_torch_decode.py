"""The port's dense-cache decode attention and KV quantization
(``accelerate_tpu_torch/ops/attention.py``, ``utils/quantization.py``)
against the JAX package's, on the same numpy-seeded inputs.

The JAX side runs its dense-arena decode kernel (#5,
``_dense_decode_kernel_call``) as its own tests do on the CPU: through
the Pallas interpreter (``impl="interpret"``) and through its plain
masked-dense read (``impl="dense"``). The port's side is the plain
PyTorch version its kernel wrappers take for CPU tensors; the CUDA
kernels are held against the same plain version on the card by
``chip_smoke.py``.

Tolerance 1e-5 on fp32 attention outputs: both sides compute the same
softmax over the same values, summed in another order (online softmax
in the interpreter, einsum in PyTorch), which moves fp32 results by
reassociation noise (~1e-7 relative at these sizes). Quantization is
compared bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from accelerate_tpu.ops import attention as ja
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.ops import attention as ta
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.utils import quantization as tq

ATOL = 1e-5
RTOL = 1e-5
B, L, D = 4, 40, 16


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


def _positions(sq, per_row):
    """Shared [Sq] positions, or per-row [B, Sq] ones: rows of mixed
    depth (one at position 0) and one parked at the cache's last
    position, as the flat engine parks an inactive slot."""
    if not per_row:
        return (9 + np.arange(sq)).astype(np.int32)
    ends = np.array([sq - 1, 12, 25, L - 1])
    return (ends[:, None] - sq + 1 + np.arange(sq)[None]).astype(np.int32)


def _case(rng, h, kvh, sq):
    q = rng.standard_normal((B, h, sq, D)).astype(np.float32)
    k = rng.standard_normal((B, kvh, L, D)).astype(np.float32)
    v = rng.standard_normal((B, kvh, L, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("impl", ["interpret", "dense"])
@pytest.mark.parametrize("per_row", [False, True], ids=["shared_pos", "per_row_pos"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_decode_attention_matches(h, kvh, sq, per_row, impl):
    rng = np.random.RandomState(0)
    q, k, v = _case(rng, h, kvh, sq)
    pos = _positions(sq, per_row)
    ref = ja.decode_attention(_j(q), _j(k), _j(v), q_positions=_j(pos), impl=impl)
    before = dict(kernels.launch_counts)
    got = ta.decode_attention(_t(q), _t(k), _t(v), q_positions=_t(pos))
    assert kernels.launch_counts == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["interpret", "dense"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("sq", [1, 4])
def test_quantized_decode_attention_matches(bits, sq, impl):
    """Identical int8 / int4 payloads and scales on both sides (made by
    the reference's quantize_kv) through the JAX kernel's fused dequant
    and through the port's dequantize-then-read."""
    rng = np.random.RandomState(1)
    q, k, v = _case(rng, 4, 2, sq)
    kq, ks = (np.array(a) for a in jq.quantize_kv(_j(k), bits))
    vq, vs = (np.array(a) for a in jq.quantize_kv(_j(v), bits))
    pos = _positions(sq, True)
    ref = ja.decode_attention(_j(q), _j(kq), _j(vq), q_positions=_j(pos), impl=impl,
                              k_scale=_j(ks), v_scale=_j(vs), kv_quant_bits=bits)
    got = ta.decode_attention(_t(q), _t(kq), _t(vq), q_positions=_t(pos),
                              k_scale=_t(ks), v_scale=_t(vs), kv_quant_bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_wide_query_block_takes_the_masked_dense_read():
    """Sq > 16 is prefill-shaped: the reference reads it masked-dense by
    design, and so does the port (no kernel, on any device)."""
    rng = np.random.RandomState(2)
    q, k, v = _case(rng, 4, 2, 20)
    pos = _positions(20, True)
    ref = ja.decode_attention(_j(q), _j(k), _j(v), q_positions=_j(pos), impl="interpret")
    got = ta.decode_attention(_t(q), _t(k), _t(v), q_positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_stale_entries_past_the_frontier_are_unobservable():
    """Garbage past each row's position (a previous occupant of the slot,
    bucket padding) cannot move any output."""
    rng = np.random.RandomState(3)
    q, k, v = _case(rng, 4, 2, 1)
    pos = _positions(1, True)
    clean = ta.decode_attention(_t(q), _t(k), _t(v), q_positions=_t(pos))
    k2, v2 = k.copy(), v.copy()
    for b, p in enumerate(pos[:, 0]):
        k2[b, :, p + 1:], v2[b, :, p + 1:] = 1e6, -1e6
    dirty = ta.decode_attention(_t(q), _t(k2), _t(v2), q_positions=_t(pos))
    np.testing.assert_array_equal(dirty.numpy(), clean.numpy())


def test_decode_attention_needs_scales():
    q = torch.zeros((1, 2, 1, 8))
    k = torch.zeros((1, 1, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        ta.decode_attention(q, k, k, q_positions=torch.zeros((1, 1), dtype=torch.int32),
                            kv_quant_bits=8)


def test_quant_wrapper_routes_cpu_tensors_to_plain():
    rng = np.random.RandomState(4)
    q, k, v = _case(rng, 4, 2, 1)
    kq, ks = tq.quantize_kv(_t(k), 8)
    vq, vs = tq.quantize_kv(_t(v), 8)
    pos = _t(_positions(1, True))
    before = dict(kernels.launch_counts)
    out = kernels.dense_decode_quant(_t(q), kq, vq, ks, vs, pos, 0.25, 8)
    ref = ta.decode_attention_reference(_t(q), kq, vq, pos, 0.25, k_scale=ks, v_scale=vs,
                                        kv_quant_bits=8)
    assert kernels.launch_counts == before
    torch.testing.assert_close(out, ref, atol=0.0, rtol=0.0)
    with pytest.raises(ValueError, match="8 or 4 bits"):
        kernels.dense_decode_quant(_t(q), kq, vq, ks, vs, pos, 0.25, 2)


# -- KV quantization, bit for bit ---------------------------------------------


def _quant_inputs():
    """Random rows of mixed sign and magnitude, an all-zero row, a
    negative-only row, and rows whose values land exactly on .5 after
    scaling (amax 127 resp. 7 makes the scale 1.0)."""
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((6, 3, 64)) * rng.uniform(0.01, 20, (6, 3, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1] = -np.abs(x[0, 1])
    ties8 = np.concatenate([[127.0], np.arange(-31, 32) + 0.5]).astype(np.float32)
    ties4 = np.concatenate([[7.0], np.resize([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 6.5, -6.5], 63)])
    x[1, 0], x[1, 1] = ties8, ties4.astype(np.float32)
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_bit_exact(bits):
    x = _quant_inputs()
    jpay, jscale = jq.quantize_kv(_j(x), bits)
    tpay, tscale = tq.quantize_kv(_t(x), bits)
    assert tpay.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    assert float(tscale[0, 0, 0]) == 1.0 and not tpay[0, 0].any()  # zero row
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_kv(tpay, tscale, bits, dtype)
        ref = jq.dequantize_kv(jpay, jscale, bits, jdtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref).astype(np.float32))


def test_unpack_and_dequantize_every_byte():
    """All 256 int8 byte values: the int4 unpack (low nibble
    sign-extended by ``(b << 4) >> 4`` on int8, high nibble by an
    arithmetic shift) and the int8 dequant at a few scales."""
    payload = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    np.testing.assert_array_equal(tq.unpack_int4_kv(_t(payload)).numpy(),
                                  np.asarray(jq.unpack_int4_kv(_j(payload))))
    scale = np.array([[1.0], [0.0123], [3.7], [1e-3]], np.float32)
    for bits in (8, 4):
        got = tq.dequantize_kv(_t(payload), _t(scale), bits, torch.bfloat16)
        ref = jq.dequantize_kv(_j(payload), _j(scale), bits, jnp.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref).astype(np.float32))


def test_quantize_kv_rejects_bad_inputs():
    with pytest.raises(ValueError, match="8 or 4 bits"):
        tq.quantize_kv(torch.zeros(2, 8), 2)
    with pytest.raises(ValueError, match="even head_dim"):
        tq.quantize_kv(torch.zeros(2, 7), 4)
    assert [tq.kv_cache_bits(d) for d in (None, "bf16", "int8", "int4")] == [16, 16, 8, 4]
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tq.kv_cache_bits("fp8")
