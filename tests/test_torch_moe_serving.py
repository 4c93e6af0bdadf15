"""MoE decoders served and generated by the port against the JAX package
on the CPU: greedy tokens identical, request for request.

An MoE block routes each batch row of a forward as one group whose
expert queues its tokens share (capacity ``int(rows * k * factor / E)``):
a padded flat chunk, a packed ragged-prefill row with its pads, a decode
batch and a verify step are each other groups than ``generate()``'s
whole-prompt row. The reference engine therefore departs from the
reference ``generate()`` on some prompts (here the 5-token one at E 4,
k 2, on the flat arena), and the port's engine is held to the reference ENGINE at
the same options, on the flat arena (chunk buckets (4, 8)), the paged
arena at pages of 8 and 16, int8 KV, and with speculative verify.

The JAX side runs its Pallas kernels in the interpreter
(``decode_kernel`` / ``prefill_kernel="interpret"``); the port's side
runs the kernels' plain versions (CPU tensors).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.serving import ServingEngine as JaxEngine
from accelerate_tpu_torch import generation
from accelerate_tpu_torch.generation import generate
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.utils import cuda_graphs

MOE = dict(moe_num_experts=4, moe_top_k=2)
NEW = 6
LENGTHS = (5, 8, 12, 3)


@pytest.fixture(scope="module")
def models():
    common = dict(max_seq_len=64, **MOE)
    jmodel = JaxLM(JaxConfig.tiny(decode_kernel="interpret", prefill_kernel="interpret",
                                  **common))
    params, _ = unbox_params(
        jmodel.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = DecoderConfig.tiny(**common)
    model = DecoderLM(cfg, device="cpu").load_params(from_reference(params, cfg))
    return jmodel, params, model


def _prompts(lengths=LENGTHS):
    rng = np.random.RandomState(0)
    return [rng.randint(3, 250, (n,)) for n in lengths]


def _engine_tokens(engine, prompts):
    return [np.asarray(t) for t in engine.generate_batched(prompts, max_new_tokens=NEW)]


ENGINES = {
    "flat": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=None),
    "paged8": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=8),
    "paged16": dict(num_slots=4, max_cache_len=64, prefill_chunks=(16, 32), page_size=16),
    "paged8-int8": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=8,
                        kv_cache_dtype="int8"),
    "flat-int8": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=None,
                      kv_cache_dtype="int8"),
    "spec": dict(num_slots=2, max_cache_len=64, prefill_chunks=(4, 8), page_size=8,
                 spec_draft_len=3),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_reference_engine(models, name):
    """Tokens of every request equal the reference engine's at the same
    options: the same routing groups (rows, pads and positions)."""
    jmodel, params, model = models
    kw = ENGINES[name]
    prompts = _prompts()
    ref = _engine_tokens(JaxEngine(jmodel, params, **kw), prompts)
    ours = _engine_tokens(ServingEngine(model, device="cpu", **kw), prompts)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_engine_departs_from_generate(models):
    """The finding the engine tests rest on: the flat engine's padded
    chunks route some prompts in other groups than generate()'s
    whole-prompt rows, so their tokens differ from generate()'s, on
    both sides alike (here the 5-token prompt, a 4 + 1 chunk pair), while
    the whole-chunk 8-token prompt keeps generate()'s."""
    jmodel, params, model = models
    prompts = _prompts()
    ours = _engine_tokens(ServingEngine(model, device="cpu", **ENGINES["flat"]), prompts)
    ref = _engine_tokens(JaxEngine(jmodel, params, **ENGINES["flat"]), prompts)
    same, same_ref = [], []
    for p, e, r in zip(prompts, ours, ref):
        alone = generate(model, torch.as_tensor(p[None]), max_new_tokens=NEW)[0].numpy()
        ref_alone = np.asarray(jgen.generate(jmodel, params, jnp.asarray(p[None]),
                                             max_new_tokens=NEW))[0]
        np.testing.assert_array_equal(alone, ref_alone)
        same.append(bool(np.array_equal(alone, e)))
        same_ref.append(bool(np.array_equal(ref_alone, r)))
    assert same == same_ref
    assert same[0] is False and same[1] is True


@pytest.mark.parametrize("s", [7, 24])
def test_greedy_generate_matches_reference(models, s):
    """generate() routes each prompt row as one group at prefill and each
    [B, 1] decode row as its own: tokens equal the reference's at B 2."""
    jmodel, params, model = models
    ids = np.random.RandomState(s).randint(3, 250, (2, s)).astype(np.int32)
    ref = np.asarray(jgen.generate(jmodel, params, jnp.asarray(ids), max_new_tokens=NEW))
    got = generate(model, torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), ref)


class _FakeGraph:
    """A captured step for the CPU: replays rerun the body."""

    def __init__(self, body, launches):
        self.body, self.launches, self.seconds = body, launches, 0.0

    def replay(self):
        return self.body()


def _fake_capture(body, device, restore=()):
    """``cuda_graphs.capture`` rehearsed on the CPU: two warm-up calls and
    the "capture" under ``kernels.recording()`` with the ``restore``
    buffers put back after each (a real capture executes nothing)."""
    saved = [t.clone() for t in restore]
    with kernels.recording() as launches:
        for _ in range(3):
            body()
            for t, s in zip(restore, saved):
                t.copy_(s)
    return _FakeGraph(body, dict(launches))


def test_captured_decode_matches_eager(models, monkeypatch):
    """generate()'s decode step through the graph plumbing (the capture
    stubbed on the CPU) gives the eager loop's tokens on an MoE model,
    and the engine's captured decode step its eager tokens: the routing
    reads no host value inside the step."""
    _, _, model = models
    ids = torch.as_tensor(np.random.RandomState(1).randint(3, 250, (3, 9)))
    eager = generate(model, ids, max_new_tokens=NEW)
    prompts = _prompts()
    eager_engine = _engine_tokens(ServingEngine(model, device="cpu", **ENGINES["paged8"]),
                                  prompts)
    monkeypatch.setattr(cuda_graphs, "captures", lambda device: True)
    monkeypatch.setattr(cuda_graphs, "capture", _fake_capture)
    captured = generate(model, ids, max_new_tokens=NEW)
    np.testing.assert_array_equal(captured.numpy(), eager.numpy())
    engine = ServingEngine(model, device="cpu", **ENGINES["paged8"])
    for a, b in zip(_engine_tokens(engine, prompts), eager_engine):
        np.testing.assert_array_equal(a, b)
    assert "decode" in engine._graphs
    assert generation.cuda_graphs.captures(torch.device("cpu"))
