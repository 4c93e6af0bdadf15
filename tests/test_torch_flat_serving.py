"""The port's flat-arena ``ServingEngine`` (``page_size=None``,
``accelerate_tpu_torch/serving/arena.py``) against the JAX package's flat
engine on the CPU: greedy tokens identical, request for request, with
the reference's weights carried through ``models/convert.py``.

The JAX engine decodes through its dense-arena Pallas kernel (#5) in the
interpreter (``decode_kernel="interpret"``); the port's engine runs the
kernels' plain versions (CPU tensors). Both admit by bucketed chunked
prefill against a slot view with buckets (4, 8) over 2 slots, so a
prompt longer than 8 tokens takes several chunks, mixed lengths fill
both buckets and later requests reuse freed slots without clearing.
"""

import numpy as np
import pytest

import jax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving.arena import arena_nbytes, arena_num_slots
from accelerate_tpu_torch.serving.engine import ServingEngine

ENG_KW = dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8))
NEW = 6


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=64, decode_kernel="interpret")
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


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8", "int4"])
def test_flat_engine_matches_reference(models, kv_cache_dtype):
    """Mixed prompt lengths across both chunk buckets (3, 5, 8, 12), a
    prompt longer than the largest bucket (20: chunks 8 + 8 + 4), and five
    requests on two slots, so three of them reuse a freed slot whose
    stale K/V is never cleared."""
    jmodel, params, model = models
    prompts = _prompts(0, (5, 3, 12, 20, 8))
    jeng = JaxEngine(jmodel, params, kv_cache_dtype=kv_cache_dtype, **ENG_KW)
    assert jeng.page_size is None
    teng = ServingEngine(model, device="cpu", page_size=None,
                         kv_cache_dtype=kv_cache_dtype, **ENG_KW)
    jreqs = [jeng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
    jeng.run()
    treqs = [teng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.outcome == j.outcome == "finished"
        np.testing.assert_array_equal(t.result(), j.result())
    assert [r.prefill_dispatches for r in treqs] == [2, 1, 2, 3, 1]
    m = teng.metrics()
    assert m["serving/generated_tokens"] == NEW * len(prompts)
    assert m["serving/prefill_dispatches"] == 9 and "serving/pages_in_use" not in m
    arena = teng._arena
    assert arena_num_slots(arena) == 2
    if kv_cache_dtype != "bf16":
        assert arena[0]["k"].dtype == arena[0]["v"].dtype == torch.int8
        assert tuple(arena[0]["k_scale"].shape) == (2, 2, 64, 1)
    # per layer: K and V of 2 slots x 2 kv heads x 64 positions x 16 dims,
    # fp32 (tiny's compute dtype), or an int8 / packed int4 payload plus
    # one fp32 scale a token
    per_token = {"bf16": 16 * 4, "int8": 16 + 4, "int4": 8 + 4}[kv_cache_dtype]
    assert arena_nbytes(arena) == m["serving/arena_bytes"] == 2 * 2 * 2 * 2 * 64 * per_token


def test_flat_and_paged_engines_agree(models):
    """One request set through both of the port's arenas: the same greedy
    tokens (the paged engine is held against the JAX package by
    tests/test_torch_serving.py)."""
    _, _, model = models
    prompts = _prompts(1, (9, 4, 17, 2, 30))
    flat = ServingEngine(model, device="cpu", page_size=None, **ENG_KW).generate_batched(
        prompts, max_new_tokens=NEW)
    paged = ServingEngine(model, device="cpu", page_size=8, **ENG_KW).generate_batched(
        prompts, max_new_tokens=NEW)
    for a, b in zip(flat, paged):
        np.testing.assert_array_equal(a, b)


def test_quantized_paged_arena_raises(models):
    """The quantized paged arena no longer raises (the int8/int4 entries
    of the paged kernels are ported): both arenas take the KV storage
    from the engine knob or the model config, and only an unknown dtype
    raises."""
    _, _, model = models
    for kv in ("int8", "int4"):
        eng = ServingEngine(model, device="cpu", page_size=8, kv_cache_dtype=kv, **ENG_KW)
        width = 16 if kv == "int8" else 8
        assert tuple(eng._arena[0]["k"].shape) == (eng.num_pages, 2, 8, width)
        assert tuple(eng._arena[0]["k_scale"].shape) == (eng.num_pages, 2, 8, 1)
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=64, kv_cache_dtype="int4")
    quantized = DecoderLM(cfg, device="cpu").load_params(model.state_dict())
    eng = ServingEngine(quantized, device="cpu", page_size=8, **ENG_KW)
    assert eng.kv_cache_dtype == "int4" and eng._arena[0]["k"].dtype == torch.int8
    eng = ServingEngine(quantized, device="cpu", page_size=None, **ENG_KW)
    assert eng.kv_cache_dtype == "int4" and tuple(eng._arena[0]["k"].shape) == (2, 2, 64, 8)
    for page_size in (None, 8):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            ServingEngine(model, device="cpu", page_size=page_size, kv_cache_dtype="fp8",
                          **ENG_KW)
