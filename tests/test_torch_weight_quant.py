"""The port's weight quantization (``accelerate_tpu_torch/utils/quantization.py``,
the native helper ``runtime/native.py`` + ``csrc/host_runtime.cpp``)
against the JAX package's (``accelerate_tpu/utils/quantization.py``).

Inputs are numpy from a seed, the same arrays on both sides (bf16 through
``ml_dtypes`` on the reference's side and torch's bf16 on the port's: the
same bits). Tolerances:

- quantized data and scales: bit for bit, from the port's plain version
  and from its native helper (the helper is built with g++ here);
- ``dequantize_array``: bit for bit, but with double quantization, whose
  scales come back through ``exp``: XLA's and torch's ``exp`` differ by
  one ulp on ~10% of fp32 inputs, so the dequantized scales are held to
  1 ulp and the weights to the rounding that ulp can move (2^-22
  relative in fp32, 2^-8 in bf16);
- the per-layer view of a stacked leaf: bit for bit against the whole
  leaf's dequantization (same device, same arithmetic).

The stacked llama-shaped leaf of the reference's scan tree (K = 32 layers
< group 128, so one group and one scale per column shared by all layers;
int4 packs layer pairs) runs at [32, 64, 96].
"""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.utils import quantization as R
from accelerate_tpu_torch.runtime import native
from accelerate_tpu_torch.utils import quantization as P

CODES = [(8, "linear", False), (4, "linear", False), (4, "linear", True), (4, "nf4", False),
         (4, "nf4", True)]
CODE_IDS = ["int8", "int4", "int4-dq", "nf4", "nf4-dq"]
SHAPES = [(64, 33), (5, 17), (9, 8, 3), (256, 40), (32, 64, 96)]


def _weights(shape, dtype, seed=0):
    """(reference array, port tensor) of the same values."""
    w = (np.random.RandomState(seed).standard_normal(shape) * 0.02).astype(np.float32)
    if dtype == "bf16":
        return w.astype(ml_dtypes.bfloat16), torch.from_numpy(w).bfloat16()
    return w, torch.from_numpy(w)


def _assert_same_scale(ref_scale, port_scale):
    if isinstance(ref_scale, R.QuantizedScale):
        assert isinstance(port_scale, P.QuantizedScale)
        np.testing.assert_array_equal(np.asarray(ref_scale.data), port_scale.data.numpy())
        np.testing.assert_array_equal(np.asarray(ref_scale.scale2), port_scale.scale2.numpy())
        assert np.float32(ref_scale.offset) == port_scale.offset.item()
        assert tuple(ref_scale.shape) == port_scale.shape
    else:
        np.testing.assert_array_equal(np.asarray(ref_scale), port_scale.numpy())


@pytest.mark.parametrize("group", [128, 8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bits,qtype,dq", CODES, ids=CODE_IDS)
def test_quantize_array_host_matches_reference(bits, qtype, dq, shape, dtype, group):
    wr, wt = _weights(shape, dtype)
    ref = R.quantize_array_host(wr, bits=bits, group_size=group, qtype=qtype, double_quant=dq)
    got = P.quantize_array_host(wt, bits=bits, group_size=group, qtype=qtype, double_quant=dq)
    assert (got.shape, got.bits, got.group, got.qtype) == (tuple(ref.shape), ref.bits,
                                                          ref.group, ref.qtype)
    assert got.dtype == wt.dtype
    np.testing.assert_array_equal(np.asarray(ref.data), got.data.numpy())
    _assert_same_scale(ref.scale, got.scale)
    # the plain version alone gives the same bits (the native helper took
    # the leaf above wherever its shape rule allows)
    data, scale = P._quantize_plain(wt, got.group, bits, qtype == "nf4")
    np.testing.assert_array_equal(np.asarray(ref.data), data.numpy())
    if not dq:
        np.testing.assert_array_equal(np.asarray(ref.scale), scale.numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bits,qtype,dq", CODES, ids=CODE_IDS)
def test_dequantize_array_matches_reference(bits, qtype, dq, shape, dtype):
    wr, wt = _weights(shape, dtype, seed=1)
    ref = R.quantize_array_host(wr, bits=bits, group_size=8, qtype=qtype, double_quant=dq)
    got = P.quantize_array_host(wt, bits=bits, group_size=8, qtype=qtype, double_quant=dq)
    want = np.asarray(R.dequantize_array(jax.tree_util.tree_map(np.asarray, ref)))
    have = P.dequantize_array(got)
    assert have.dtype == wt.dtype and tuple(have.shape) == shape
    have = have.float().numpy()
    want = want.astype(np.float32)
    if not dq:
        np.testing.assert_array_equal(want, have)
        return
    ref_scales = np.asarray(R._dequantize_scales(jax.tree_util.tree_map(np.asarray, ref.scale)))
    np.testing.assert_array_max_ulp(ref_scales, P._dequantize_scales(got.scale).numpy(), maxulp=1)
    np.testing.assert_allclose(have, want, rtol=2.0 ** -22 if dtype == "f32" else 2.0 ** -8,
                               atol=0)


@pytest.mark.parametrize("group", [128, 8, 3])
@pytest.mark.parametrize("bits,qtype,dq", CODES, ids=CODE_IDS)
def test_layer_view_equals_row_of_whole_dequantization(bits, qtype, dq, group):
    """The per-layer view of a stacked leaf: layer i from its own data
    row (int8) or a nibble of byte row i // 2 (int4), and scale row
    i // group."""
    k = 9 if group == 3 else 32
    _, wt = _weights((k, 16, 24), "bf16", seed=2)
    qw = P.quantize_array_host(wt, bits=bits, group_size=group, qtype=qtype, double_quant=dq)
    whole = P.dequantize_array(qw)
    for i in range(k):
        assert torch.equal(qw.layer(i).weight(), whole[i]), i
    code = torch.from_numpy(P.NF4_CODE)
    assert torch.equal(P.QuantizedLayer(qw, 3, "cpu", code).weight(), whole[3])
    assert torch.equal(P.QuantizedLayer(qw).weight(), whole)
    with pytest.raises(IndexError):
        qw.layer(k)


def test_stacked_llama_leaf_quantizes_along_the_layer_axis():
    """A [32, E, M] stacked leaf at group 128: one group of 32 layers, one
    fp32 scale per column shared by all of them, int4 packing layer pairs
    into a byte (16 byte rows), as in the reference."""
    wr, wt = _weights((32, 64, 96), "bf16", seed=3)
    for bits, rows in ((8, 32), (4, 16)):
        ref = R.quantize_array_host(wr, bits=bits)
        got = P.quantize_array_host(wt, bits=bits)
        assert got.group == ref.group == 32
        assert tuple(got.data.shape) == (rows, 64, 96) and tuple(got.scale.shape) == (1, 64, 96)
        np.testing.assert_array_equal(np.asarray(ref.data), got.data.numpy())


@pytest.mark.parametrize("bits,nf4", [(8, False), (4, False), (4, True)],
                         ids=["int8", "int4", "nf4"])
@pytest.mark.parametrize("shape,group", [((64, 33), 8), ((32, 64, 96), 32), ((7, 5), 7),
                                         ((128, 3000), 128), ((6, 1), 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_native_helper_bit_exact_against_plain(dtype, shape, group, bits, nf4):
    w = torch.from_numpy(np.random.RandomState(4).standard_normal(shape).astype(np.float32))
    w = (w * 0.05).to(dtype)
    w[0] = 0  # an all-zero row: scale 1
    assert native.native_quantize_supported(shape, group, bits, dtype)
    data, scale = native.quantize_group_native(w, group, bits, nf4)
    want_data, want_scale = P._quantize_plain(w, group, bits, nf4)
    assert torch.equal(data, want_data) and torch.equal(scale, want_scale)


def test_native_calls_from_threads_run_one_at_a_time(monkeypatch):
    """Each native call already runs a thread per core: calls from the
    load pipeline's quantize workers take turns instead of running
    cores x workers threads at once."""
    import threading
    import time

    active, most = [0], [0]
    guard = threading.Lock()

    class FakeLib:
        def host_quantize_group(self, *args):
            with guard:
                active[0] += 1
                most[0] = max(most[0], active[0])
            time.sleep(0.02)
            with guard:
                active[0] -= 1
            return 0

    monkeypatch.setattr(native, "_get_lib", lambda: FakeLib())
    w = torch.ones(4, 8)
    threads = [threading.Thread(target=native.quantize_group_native, args=(w, 4, 8, False))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and most[0] == 1


def test_native_gate_is_the_reference_shape_rule():
    """Where the reference's native path declines a shape (returns None),
    the port's gate sends it to the plain version, and only there."""
    import accelerate_tpu.runtime.native as rnative

    if not rnative.native_available():
        pytest.skip("the reference's native helper did not build here")
    for k in (1, 2, 5, 6, 8, 9, 32):
        for group in (1, 2, 3, 5, 8, 32):
            if k % group:
                continue
            for bits in (8, 4):
                w = np.zeros((k, 4), np.float32)
                w[0, 0] = 1
                declined = rnative.quantize_group_native(w, group, bits, False) is None
                assert native.native_quantize_supported((k, 4), group, bits, torch.float32) \
                    == (not declined), (k, group, bits)
    assert not native.native_quantize_supported((4, 4), 2, 8, torch.float16)


def test_native_library_is_keyed_by_source_and_flags():
    lib = native.build()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib == native.library_path()
    assert "-march=native" in native.CFLAGS and "-ffp-contract=off" in native.CFLAGS


def test_config_defaults_and_validation_match_reference():
    for kw in ({"load_in_8bit": True}, {"load_in_4bit": True},
               {"load_in_4bit": True, "quant_type": "nf4", "double_quant": True}):
        ref, got = R.QuantizationConfig(**kw), P.QuantizationConfig(**kw)
        assert (got.bits, got.group_size, got.skip_modules, got.min_dims, got.quant_type,
                got.double_quant) == (ref.bits, ref.group_size, ref.skip_modules, ref.min_dims,
                                      ref.quant_type, ref.double_quant)
    for kw in ({}, {"load_in_8bit": True, "load_in_4bit": True},
               {"load_in_4bit": True, "quant_type": "fp4"},
               {"load_in_8bit": True, "quant_type": "nf4"},
               {"load_in_8bit": True, "double_quant": True}):
        with pytest.raises(ValueError):
            R.QuantizationConfig(**kw)
        with pytest.raises(ValueError):
            P.QuantizationConfig(**kw)
    with pytest.raises(ValueError, match="4-bit"):
        P.quantize_array_host(torch.ones(4, 4), bits=8, qtype="nf4")


def _tiny_tree():
    rng = np.random.RandomState(6)
    return {
        "embedding": rng.standard_normal((64, 32)).astype(np.float32),
        "layers": {"block": {
            "attn": {"wq": rng.standard_normal((3, 32, 4, 8)).astype(np.float32)},
            "ln_attn": np.ones((3, 32), np.float32),
            "mlp": {"w_up": rng.standard_normal((3, 32, 48)).astype(np.float32)},
        }},
        "lm_head": rng.standard_normal((32, 64)).astype(np.float32),
        "ln_final": np.ones((32,), np.float32),
        "step": np.arange(3, dtype=np.int32).reshape(3, 1),
    }


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("kw", [{"load_in_8bit": True, "group_size": 16},
                                {"load_in_4bit": True, "group_size": 16},
                                {"load_in_4bit": True, "quant_type": "nf4",
                                 "double_quant": True}], ids=["int8", "int4", "nf4-dq"])
def test_quantize_params_and_abstract_tree_match_reference(kw):
    from accelerate_tpu.utils.serialization import flatten_pytree as rflat
    from accelerate_tpu_torch.utils.serialization import flatten_pytree as pflat

    tree = _tiny_tree()
    rcfg, pcfg = R.QuantizationConfig(**kw), P.QuantizationConfig(**kw)
    ref = rflat(jax.tree_util.tree_map(np.asarray, R.quantize_params(tree, rcfg)))
    got = pflat(P.quantize_params(_torch_tree(tree), pcfg))
    assert list(ref) == list(got)  # same quantized leaves, same child names, same order
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(), err_msg=k)
    assert R.quantized_nbytes(R.quantize_params(tree, rcfg)) == \
        P.quantized_nbytes(P.quantize_params(_torch_tree(tree), pcfg))
    # the abstract shadow (meta tensors): the same leaves, shapes and dtypes
    rabs = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    pabs = jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, dtype=torch.from_numpy(np.array(a)).dtype,
                              device="meta"), tree)
    r = rflat(R.quantize_abstract_tree(rabs, rcfg))
    g = pflat(P.quantize_abstract_tree(pabs, pcfg))
    assert list(r) == list(g)
    for k in r:
        assert tuple(r[k].shape) == tuple(g[k].shape), k
        assert np.dtype(r[k].dtype).name == str(g[k].dtype).removeprefix("torch."), k


def test_dequantize_params_round_trips_the_tree():
    tree = _torch_tree(_tiny_tree())
    cfg = P.QuantizationConfig(load_in_8bit=True, group_size=16)
    q = P.quantize_params(tree, cfg)
    assert isinstance(q["layers"]["block"]["ln_attn"], P.QuantizedWeight)  # stacked norms too
    assert not isinstance(q["embedding"], P.QuantizedWeight)  # skipped by name
    assert not isinstance(q["ln_final"], P.QuantizedWeight)  # 1-D
    back = P.dequantize_params(q)
    assert torch.equal(back["embedding"], tree["embedding"])
    w = tree["layers"]["block"]["mlp"]["w_up"]
    torch.testing.assert_close(back["layers"]["block"]["mlp"]["w_up"], w,
                               atol=float(w.abs().max()) / 100, rtol=0)


def test_quantize_pipeline_threads_stress():
    """Many quantize calls on more threads than cores, with a short switch
    interval: every result equals the serial one (the native helper holds
    no state between calls)."""
    import sys
    import threading

    ws = [torch.from_numpy(np.random.RandomState(i).standard_normal((32, 64)).astype(np.float32))
          for i in range(24)]
    want = [P.quantize_array_host(w, bits=4, qtype="nf4").data for w in ws]
    got = [None] * len(ws)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, P.quantize_array_host(ws[i], bits=4, qtype="nf4").data))
            for i in range(len(ws))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (os.cpu_count() or 1) < 2 * len(ws)
