"""The port's ``generate()`` (``accelerate_tpu_torch/generation.py``) and
its dense-cache model branches against the JAX package's, with the
reference's weights carried through ``models/convert.py``.

The JAX side decodes through its dense-arena Pallas kernel (#5) in the
interpreter (``decode_kernel="interpret"``, ``decode_kernel_block=8``);
the port's side runs the kernels' plain versions (CPU tensors). Config:
``tiny`` with GQA 4 -> 2 and ``max_seq_len=256`` (tiny's own 128 would
cap the 256-position bucket below a 128-token prompt + 12 tokens, and
the capacity check would raise), fp32, tied and untied LM heads.

Greedy tokens must be identical. Logits are compared at 1e-4 (fp32
through two layers summed in another order by XLA and PyTorch: ~1e-6
relative, times logits of magnitude ~10). With an int8/int4 cache the
tolerance is 1e-3: a K/V value one ulp apart on the two sides can round
to payloads one apart, moving that cache entry by a whole quantization
step (at these inputs the payloads agree exactly and the logits within
1e-6).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu_torch.generation import _right_size_cache, generate
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params
from accelerate_tpu_torch.models.decoder import DecoderLM

ATOL = 1e-4
QUANT_ATOL = 1e-3
_MODELS: dict = {}


def _pair(tie=True, kv_cache_dtype="bf16", **kw):
    """(JAX model, its params, the port's model on the same weights), built
    once per configuration for the module."""
    key = (tie, kv_cache_dtype, tuple(sorted(kw.items())))
    if key not in _MODELS:
        common = dict(num_kv_heads=2, max_seq_len=256, tie_embeddings=tie,
                      kv_cache_dtype=kv_cache_dtype, **kw)
        jmodel = JaxLM(JaxConfig.tiny(decode_kernel="interpret", decode_kernel_block=8,
                                      **common))
        params, _ = unbox_params(
            jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
        params = jax.tree_util.tree_map(np.asarray, params)
        cfg = DecoderConfig.tiny(**common)
        model = DecoderLM(cfg, device="cpu").load_params(from_reference(params, cfg))
        _MODELS[key] = (jmodel, params, model)
    return _MODELS[key]


def _prompt(s, seed=0):
    return np.random.RandomState(seed).randint(3, 250, (2, s)).astype(np.int32)


@pytest.mark.parametrize("new", [1, 12])
@pytest.mark.parametrize("s", [8, 128])
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_greedy_generate_matches_reference(tie, s, new):
    jmodel, params, model = _pair(tie)
    ids = _prompt(s)
    ref = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), max_new_tokens=new))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=new)
    assert got.shape == (2, s + new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def _step_logits_jax(jmodel, params, ids, s):
    """Prefill logits of ids[:, :s], then one single-stream decode step per
    later token of ``ids`` (teacher-forced) against the JAX cache."""
    prefill = jax.jit(lambda p, i: jmodel.apply(
        {"params": p}, i, positions=jnp.arange(s), use_cache=True, mutable=["cache"]))
    step = jax.jit(lambda p, c, i, pos: jmodel.apply(
        {"params": p, "cache": c}, i, positions=pos, use_cache=True, decode=True,
        mutable=["cache"]))
    out, mutated = prefill(params, jnp.asarray(ids[:, :s]))
    logits = [np.asarray(out["logits"])]
    for t in range(s, ids.shape[1]):
        out, mutated = step(params, mutated["cache"], jnp.asarray(ids[:, t:t + 1]),
                            jnp.asarray([t]))
        logits.append(np.asarray(out["logits"]))
    return logits


def _step_logits_port(model, ids, s, length=256):
    cache = model.init_cache(ids.shape[0], length)
    with torch.no_grad():
        logits = [model(torch.from_numpy(ids[:, :s]), cache=cache).numpy()]
        for t in range(s, ids.shape[1]):
            logits.append(model(torch.from_numpy(ids[:, t:t + 1]), torch.tensor([t]),
                                cache=cache, decode=True).numpy())
    assert all(layer["index"] == ids.shape[1] for layer in cache)
    return logits


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_prefill_and_decode_step_logits_match(tie):
    jmodel, params, model = _pair(tie)
    ids = _prompt(9, seed=1)
    ref = _step_logits_jax(jmodel, params, ids, 8)
    got = _step_logits_port(model, ids, 8)
    assert [g.shape for g in got] == [(2, 8, 256), (2, 1, 256)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kv_cache_dtype", ["int8", "int4"])
def test_quantized_cache_generate_matches_reference(kv_cache_dtype):
    """Greedy tokens through an int8 / int4 cache (quantize-on-write in the
    whole-prompt prefill and every decode step, the fused dequant of the
    JAX kernel vs the port's dequantize-then-read) are identical; each
    step's logits agree within QUANT_ATOL."""
    jmodel, params, model = _pair(kv_cache_dtype=kv_cache_dtype)
    ids = _prompt(8, seed=2)
    ref = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), max_new_tokens=12))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, ref)
    for g, r in zip(_step_logits_port(model, got, 8), _step_logits_jax(jmodel, params, got, 8)):
        np.testing.assert_allclose(g, r, atol=QUANT_ATOL, rtol=QUANT_ATOL)


@pytest.mark.parametrize("s,new,max_cache_len", [
    (8, 12, None),     # 20 -> the 256 bucket
    (128, 12, None),   # 140 -> 256
    (250, 6, None),    # exactly the cap
    (8, 12, 64),       # an explicit max_cache_len is kept as it is
    (240, 30, None),   # over max_seq_len: the capacity check raises
    (40, 30, 64),      # over the explicit length: raises
])
def test_right_sized_cache_length_matches_reference(s, new, max_cache_len):
    jmodel, params, model = _pair()
    jsized = jgen._right_size_cache(jmodel.clone(config=dataclasses.replace(
        jmodel.config, max_cache_len=max_cache_len)), s, new)
    want = jsized.config.max_cache_len or jsized.config.max_seq_len
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=256, max_cache_len=max_cache_len)
    assert _right_size_cache(cfg, s, new) == want
    sized = DecoderLM(cfg, device="cpu").load_params(model.state_dict())
    ids = torch.from_numpy(_prompt(s))
    if s + new > want:
        with pytest.raises(ValueError, match="exceeds the KV cache capacity"):
            generate(sized, ids, max_new_tokens=new)
        return
    lengths = []
    init = sized.init_cache
    sized.init_cache = lambda b, n, *a: lengths.append(n) or init(b, n, *a)
    generate(sized, ids, max_new_tokens=new)
    assert lengths == [want]


def test_sampling_is_seeded_and_top1_is_greedy():
    _, _, model = _pair()
    ids = torch.from_numpy(_prompt(8, seed=3))
    greedy = generate(model, ids, max_new_tokens=8)
    top1 = generate(model, ids, max_new_tokens=8, temperature=0.7, top_k=1,
                    generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(top1, greedy)
    runs = [generate(model, ids, max_new_tokens=8, temperature=1.0, top_k=5,
                     generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1])
    with torch.no_grad():
        logits = model(runs[0])
    for i in range(8):
        top5 = torch.topk(logits[:, 7 + i], 5).indices
        assert bool((top5 == runs[0][:, 8 + i, None]).any(dim=1).all())
    out, seconds = generate(model, ids, max_new_tokens=2, return_prefill_seconds=True)
    assert out.shape == (2, 10) and seconds > 0.0
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(model, ids, max_new_tokens=0)


def test_sampling_without_a_generator_is_seed_zero():
    """Sampled generate() with no generator draws from a generator seeded
    with 0 once per call (the reference's PRNGKey(0) when given no key):
    two calls agree, and equal an explicit ``manual_seed(0)``."""
    cfg = DecoderConfig.tiny(max_seq_len=64)
    model = DecoderLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    ids = torch.arange(1, 9)[None]
    runs = [generate(model, ids, max_new_tokens=16, temperature=1.0) for _ in range(2)]
    seeded = generate(model, ids, max_new_tokens=16, temperature=1.0,
                      generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(runs[0], runs[1])
    torch.testing.assert_close(runs[0], seeded)
    assert runs[0].shape == (1, 24)
