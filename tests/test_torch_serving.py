"""The port's ``ServingEngine`` (``accelerate_tpu_torch/serving/engine.py``)
against the JAX package's on the CPU: greedy tokens identical, request
for request, with the reference's weights carried through
``models/convert.py``.

The JAX engine runs its paged decode and ragged prefill kernels through
the Pallas interpreter (``decode_kernel="interpret"``,
``prefill_kernel="interpret"``), as its own tests do; the port's engine
runs the kernels' plain versions (CPU tensors). Both use
``page_size=8`` and pack capacities (4, 8), so prompts longer than 8
tokens continue mid-tail over their own arena prefix.
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
from accelerate_tpu_torch.serving.engine import ServingEngine

ENG_KW = dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=8)
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


def _serve_both(models, prompts, waves=1):
    """Submit ``prompts`` to both engines ``waves`` times (a later wave
    replays through the prefix cache) and return both request lists."""
    jmodel, params, model = models
    jeng = JaxEngine(jmodel, params, **ENG_KW)
    assert jeng._ragged_prefill  # the interpreter-run ragged prefill path
    teng = ServingEngine(model, device="cpu", **ENG_KW)
    jreqs, treqs = [], []
    for _ in range(waves):
        jreqs += [jeng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
        jeng.run()
        treqs += [teng.submit(p, max_new_tokens=NEW, seed=i) for i, p in enumerate(prompts)]
        teng.run()
    return jreqs, treqs, teng


def _assert_same_tokens(jreqs, treqs):
    for j, t in zip(jreqs, treqs):
        assert t.outcome == j.outcome == "finished"
        np.testing.assert_array_equal(t.result(), j.result())
        assert t.prefix_hit == j.prefix_hit


def test_mixed_lengths_and_long_prompt(models):
    """Mixed prompt lengths, co-admitted into shared packs, plus a prompt
    longer than the largest pack capacity (continues mid-tail)."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, 250, (n,)) for n in (5, 3, 12, 20, 8)]
    jreqs, treqs, teng = _serve_both(models, prompts)
    _assert_same_tokens(jreqs, treqs)
    assert treqs[3].prefill_dispatches >= 3  # 20 tokens over packs of <= 8
    m = teng.metrics()
    assert m["serving/generated_tokens"] == NEW * len(prompts)
    assert m["serving/prefill_packed_tokens"] == sum(p.size for p in prompts)


def test_shared_prefix_hits_cache(models):
    """Two prompts sharing a 16-token prefix: the second admits after the
    first published its pages and prefills only its tail."""
    rng = np.random.RandomState(1)
    shared = rng.randint(3, 250, (16,))
    prompts = [np.concatenate([shared, rng.randint(3, 250, (3,))]),
               rng.randint(3, 250, (6,)),
               np.concatenate([shared, rng.randint(3, 250, (5,))])]
    jreqs, treqs, teng = _serve_both(models, prompts)
    _assert_same_tokens(jreqs, treqs)
    assert treqs[2].prefix_hit == 16
    assert teng.metrics()["serving/prefix_hit_tokens"] >= 16


def test_replay_through_prefix_cache(models):
    """The same prompts served twice: the replay admits over cached pages
    (hist > 0 in the packed dispatch, copy-on-write forks on decode) and
    must give the same tokens as the cold wave and as the reference."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, 250, (n,)) for n in (12, 7)]
    jreqs, treqs, teng = _serve_both(models, prompts, waves=2)
    _assert_same_tokens(jreqs, treqs)
    for cold, replay in zip(treqs[:2], treqs[2:]):
        np.testing.assert_array_equal(cold.result(), replay.result())
    # the 12-token prompt replays over its first page; the 7-token one
    # cannot hit (a hit must leave the last prompt token to prefill, and
    # 6 tokens are less than a page)
    assert (treqs[2].prefix_hit, treqs[3].prefix_hit) == (8, 0)
    assert teng.page_forks > 0


def test_generate_batched_matches(models):
    jmodel, params, model = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(3, 250, (n,)) for n in (9, 4, 17)]
    ref = JaxEngine(jmodel, params, **ENG_KW).generate_batched(prompts, max_new_tokens=NEW)
    got = ServingEngine(model, device="cpu", **ENG_KW).generate_batched(
        prompts, max_new_tokens=NEW)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_sampling_paths(models):
    """Temperature sampling: top_k=1 leaves only the argmax, so it equals
    greedy; a seeded request is reproducible; tokens stay in the top-k."""
    _, _, model = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, 250, (n,)) for n in (6, 11)]
    greedy = ServingEngine(model, device="cpu", **ENG_KW).generate_batched(
        prompts, max_new_tokens=NEW)
    top1 = ServingEngine(model, device="cpu", temperature=0.7, top_k=1,
                         **ENG_KW).generate_batched(prompts, max_new_tokens=NEW)
    for a, b in zip(top1, greedy):
        np.testing.assert_array_equal(a, b)
    runs = [ServingEngine(model, device="cpu", temperature=1.0, top_k=5,
                          **ENG_KW).generate_batched(prompts, max_new_tokens=NEW,
                                                     seeds=[7, 8])
            for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    seq = runs[0][0]
    logits = model(torch.as_tensor(seq, dtype=torch.long)[None])[0]
    n = prompts[0].size
    for i in range(NEW):
        top5 = torch.topk(logits[n - 1 + i], 5).indices.tolist()
        assert int(seq[n + i]) in top5


def test_eos_and_callbacks(models):
    """``on_token`` sees every token; an eos token finishes the request
    early; a raising callback cancels only its own request."""
    _, _, model = models
    rng = np.random.RandomState(5)
    prompt = rng.randint(3, 250, (7,))
    greedy = ServingEngine(model, device="cpu", **ENG_KW).generate_batched(
        [prompt], max_new_tokens=NEW)[0]
    eos = int(greedy[prompt.size + 2])
    seen = []
    eng = ServingEngine(model, device="cpu", eos_token_id=eos, **ENG_KW)
    req = eng.submit(prompt, max_new_tokens=NEW, on_token=lambda t, r: seen.append(t))

    def boom(t, r):
        raise RuntimeError("consumer failed")

    bad = eng.submit(rng.randint(3, 250, (5,)), max_new_tokens=NEW, on_token=boom)
    eng.run()
    assert req.outcome == "finished" and req.finish_reason == "eos"
    assert seen == req.tokens and req.tokens[-1] == eos
    assert bad.outcome == "cancelled" and bad.finish_reason == "callback_error"
