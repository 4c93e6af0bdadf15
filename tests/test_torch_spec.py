"""Speculative verify on the port's paged arena against the JAX package
on the CPU.

- The port's ``NGramDrafter`` proposes what the reference's does.
- The spec engine (``spec_draft_len=3``) gives the JAX spec engine's
  greedy tokens exactly, on the bf16 (here fp32) and the int8 arena (the
  JAX engine runs its paged decode kernel, Sq = K + 1, in the
  interpreter).
- Inside the port, spec and non-spec engines give the same tokens,
  greedy and sampled: the sampled case holds the generator save/restore
  (each request's generator ends where K + 1 sequential draws leave it).
  fp32 on the CPU, so the verify step's logits match the sequential
  step's; on the card bf16 GEMM shapes differ and chip_smoke.py holds
  spec tokens teacher-forced instead.
- Spec needs the paged arena, and its headroom counts against capacity.
"""

import numpy as np
import pytest

import jax

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu.serving.pages import NGramDrafter as JaxDrafter
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving import NGramDrafter
from accelerate_tpu_torch.serving.engine import ServingEngine

ENG_KW = dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=8)
NEW = 8
K = 3


@pytest.mark.parametrize("order,min_order,lookback", [(3, 1, 1024), (2, 2, 16), (4, 1, 8)])
def test_ngram_drafter_matches_reference(order, min_order, lookback):
    rng = np.random.RandomState(order * 10 + lookback)
    ours = NGramDrafter(order, min_order, lookback)
    ref = JaxDrafter(order, min_order, lookback)
    for n in (0, 1, 2, 5, 17, 40):
        for vocab in (3, 12, 500):
            ctx = rng.randint(0, vocab, (n,))
            for k in (1, 3, 6):
                np.testing.assert_array_equal(ours.propose(ctx, k), ref.propose(ctx, k))
    with pytest.raises(ValueError, match="n-gram orders"):
        NGramDrafter(1, 2)
    with pytest.raises(ValueError, match="lookback"):
        NGramDrafter(lookback=1)


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


def _prompts():
    """Mixed lengths, two of them repeating a pattern so that the drafter
    has something to propose."""
    rng = np.random.RandomState(0)
    pattern = rng.randint(3, 250, (4,))
    return [rng.randint(3, 250, (5,)), np.tile(pattern, 3), rng.randint(3, 250, (12,)),
            np.tile(pattern[:3], 5)]


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_spec_engine_matches_reference(models, kv_cache_dtype):
    jmodel, params, model = models
    prompts = _prompts()
    kw = dict(spec_draft_len=K, kv_cache_dtype=kv_cache_dtype, **ENG_KW)
    ref = JaxEngine(jmodel, params, **kw)
    ours = ServingEngine(model, device="cpu", **kw)
    for a, b in zip(ours.generate_batched(prompts, max_new_tokens=NEW),
                    ref.generate_batched(prompts, max_new_tokens=NEW)):
        np.testing.assert_array_equal(a, b)
    assert ours.spec_proposed == ref.spec_proposed > 0
    assert ours.spec_accepted == ref.spec_accepted
    m = ours.metrics()
    assert m["serving/spec_proposed"] == ours.spec_proposed
    assert m["serving/spec_accept_rate"] == ours.spec_accepted / ours.spec_proposed


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("sampling", [dict(), dict(temperature=1.0, top_k=8),
                                      dict(temperature=0.5, top_k=2)],
                         ids=["greedy", "sampled", "sampled-top2"])
def test_spec_equals_sequential(models, kv_cache_dtype, sampling):
    _, _, model = models
    prompts = _prompts()
    kw = dict(kv_cache_dtype=kv_cache_dtype, **sampling, **ENG_KW)
    seeds = [11, 12, 13, 14]
    plain = ServingEngine(model, device="cpu", **kw)
    spec = ServingEngine(model, device="cpu", spec_draft_len=K, **kw)
    for a, b in zip(plain.generate_batched(prompts, max_new_tokens=NEW, seeds=seeds),
                    spec.generate_batched(prompts, max_new_tokens=NEW, seeds=seeds)):
        np.testing.assert_array_equal(a, b)
    assert spec.spec_accepted > 0
    # every verify step emits at least one token per live slot
    assert spec.step_count <= plain.step_count


def test_spec_needs_paged_arena_and_headroom(models):
    _, _, model = models
    with pytest.raises(ValueError, match="requires the paged arena"):
        ServingEngine(model, device="cpu", spec_draft_len=K,
                      **{**ENG_KW, "page_size": None})
    spec = ServingEngine(model, device="cpu", spec_draft_len=K, **ENG_KW)
    plain = ServingEngine(model, device="cpu", **ENG_KW)
    prompt = np.arange(3, 3 + 50)
    plain.submit(prompt, max_new_tokens=14)  # 50 + 14 = 64 fits
    with pytest.raises(ValueError, match="spec headroom"):
        spec.submit(prompt, max_new_tokens=14)
    spec.submit(prompt, max_new_tokens=14 - K)
