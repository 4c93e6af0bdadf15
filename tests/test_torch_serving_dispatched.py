"""Serving a dispatched model: the port's ``ServingEngine.from_dispatched``
(``accelerate_tpu_torch/serving/engine.py``) over the port's
``DispatchedModel`` (``big_modeling.py``), on the CPU.

- The reference's own case (``tests/test_serving.py``
  ``test_from_dispatched_offloaded``, its inputs: ``DecoderConfig.tiny(
  max_seq_len=64)`` initialised from ``PRNGKey(0)``, prompts of lengths 5,
  8, 12 and 3 from ``RandomState(0)``, ``cpu_offload``, two slots, cache
  64, one prefill chunk of 8): the greedy tokens of the first two
  prompts, 4 each, equal the reference's ``generate()`` on the plain
  params, on the flat arena and on the paged one.
- A map with a disk tier: the same tokens; the engine holds the
  dispatched model's binding (its disk-tier weights loaded) for its life,
  and ``close()`` releases it.
- int8 quantized on load: the engine's tokens equal ``generate_dispatched``
  on the same load.
- The engine's CUDA-graph path rehearsed on the CPU (the capture stubbed
  to a step whose replay reruns the body): the streamed weights are
  copied inside every replayed step, tokens unchanged.
- ``param_placer`` raises, naming ``from_dispatched``.

Greedy tokens are compared exactly: both sides run fp32 (the tiny
config), and the prompts' top-two logit gaps (printed) are far above
the ~1e-6 the two frameworks' summation orders move a logit.
"""

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import generate as ref_generate
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu_torch import big_modeling as PB
from accelerate_tpu_torch.generation import generate_dispatched
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.serving.engine import ServingEngine
from accelerate_tpu_torch.utils import cuda_graphs
from accelerate_tpu_torch.utils.quantization import QuantizationConfig

NEW = 4
ENGINE = dict(num_slots=2, max_cache_len=64, prefill_chunks=(8,))


@pytest.fixture(scope="module")
def served():
    """The reference test's model, params and prompts, and the reference's
    greedy ``generate()`` of the first two prompts (prompt + 4 tokens)."""
    jm = JaxLM(JaxConfig.tiny(max_seq_len=64))
    params, _ = unbox_params(
        jm.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, 256, (n,)) for n in (5, 8, 12, 3)]
    refs = [np.asarray(ref_generate(jm, params, p[None], max_new_tokens=NEW,
                                    rng=jax.random.PRNGKey(i))[0])
            for i, p in enumerate(prompts[:2])]
    return params, DecoderConfig.tiny(max_seq_len=64), prompts, refs


def _serve(engine, prompts):
    before = engine.generated_tokens
    outs = engine.generate_batched(prompts, max_new_tokens=NEW)
    assert engine.generated_tokens - before == NEW * len(prompts)
    return outs


@pytest.mark.parametrize("page_size", [None, 8], ids=["flat", "paged"])
def test_from_dispatched_offloaded_equals_reference_generate(served, page_size):
    params, cfg, prompts, refs = served
    dispatched = PB.cpu_offload(cfg, params, device="cpu")
    engine = ServingEngine.from_dispatched(dispatched, page_size=page_size, **ENGINE)
    assert engine.model is dispatched.model and engine.device == torch.device("cpu")
    streamed = [w for blk in engine.model.layers for w in blk.streamed]
    assert streamed and all(w.host is not None for w in streamed)
    with torch.no_grad():
        gaps = []
        for p, r in zip(prompts[:2], refs):
            logits = dispatched(torch.from_numpy(r[None, :-1].copy()))[0, p.size - 1:]
            gaps.append(float(torch.topk(logits, 2).values.diff(dim=-1).abs().min()))
    print(f"smallest top-two logit gap: {min(gaps):.3e}")
    for out, ref in zip(_serve(engine, prompts[:2]), refs):
        np.testing.assert_array_equal(out, ref)
    engine.close()


def test_disk_tier_binding_is_held_until_close(served, tmp_path):
    """Embedding and lm-head leaves on disk, the blocks in host memory:
    the engine's model is the binding with the disk leaves loaded, kept
    for the engine's life (two rounds of requests); ``close()`` releases
    it, drops the engine's model and arena, and the dispatched model
    binds its disk handles again."""
    params, cfg, prompts, refs = served
    dispatched = PB.dispatch_model(cfg, params, {"": "device", "layers": "cpu",
                                                 "embedding": "disk"},
                                   offload_folder=str(tmp_path), device="cpu")
    assert all(w.host is None for w in dispatched.model.streamed)
    engine = ServingEngine.from_dispatched(dispatched, page_size=8, **ENGINE)
    held = engine.model
    assert held.streamed and all(w.host is not None for w in held.streamed)
    for _ in range(2):
        for out, ref in zip(_serve(engine, prompts[:2]), refs):
            np.testing.assert_array_equal(out, ref)
        assert engine.model is held and dispatched.model is held
    engine.close()
    assert engine.model is None and engine._arena is None
    assert dispatched.model is not held
    assert all(w.host is None for w in dispatched.model.streamed)
    engine.close()  # once released, a no-op
    ServingEngine(dispatched.model, device="cpu", **ENGINE).close()  # no binding: no-op


def test_int8_on_load_equals_generate_dispatched(served):
    params, cfg, prompts, _ = served
    dispatched = PB.load_and_quantize_model(
        cfg, params, QuantizationConfig(load_in_8bit=True, group_size=32), device="cpu")
    want = [generate_dispatched(dispatched, torch.as_tensor(p[None]),
                                max_new_tokens=NEW)[0].numpy() for p in prompts]
    for page_size in (None, 8):
        engine = ServingEngine.from_dispatched(dispatched, page_size=page_size, **ENGINE)
        for out, ref in zip(_serve(engine, prompts), want):
            np.testing.assert_array_equal(out, ref)
        engine.close()


def test_graph_path_streams_the_weights_in_each_replay(served, monkeypatch):
    """The engine's CUDA branch on the CPU: the decode step is "captured"
    (a stub whose replay reruns the body) and every decode step replays
    it; the host-tier weights are staged into their device
    buffers inside each replay, once per block, and the tokens equal the
    reference's."""
    params, cfg, prompts, refs = served
    replays = []

    class Step:
        def __init__(self, body, device, restore=()):
            self.body, self.seconds, self.launches = body, 0.0, {}

        def replay(self):
            replays.append(1)
            return self.body()

    monkeypatch.setattr(cuda_graphs, "captures", lambda device: True)
    monkeypatch.setattr(cuda_graphs, "capture", Step)
    dispatched = PB.cpu_offload(cfg, params, device="cpu")
    engine = ServingEngine.from_dispatched(dispatched, page_size=8, **ENGINE)
    staged = []
    real = type(engine.model.layers[0].streamed[0]).stage

    def counting(w):
        staged.append(w)
        return real(w)

    monkeypatch.setattr(type(engine.model.layers[0].streamed[0]), "stage", counting)
    engine._step_fn("decode")
    assert list(engine._graphs) == ["decode"]
    for out, ref in zip(_serve(engine, prompts[:2]), refs):
        np.testing.assert_array_equal(out, ref)
    assert len(replays) == engine.step_count > 0
    per_block = len(engine.model.layers[0].streamed)
    # every replay and every prefill dispatch staged each block's weights
    runs = engine.step_count + engine.prefill_dispatches
    assert len(staged) >= runs * per_block * cfg.num_layers
    engine.close()


def test_param_placer_names_from_dispatched(served):
    params, cfg, _, _ = served
    dispatched = PB.cpu_offload(cfg, params, device="cpu")
    with pytest.raises(NotImplementedError, match="from_dispatched"):
        ServingEngine(dispatched.model, device="cpu", param_placer=object(), **ENGINE)
