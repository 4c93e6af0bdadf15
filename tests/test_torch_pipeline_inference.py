"""Inference through pipeline stages against the JAX reference on the CPU:
``inference.prepare_pippy``, ``generation.depipeline`` with
``generate()``, and a ``ServingEngine`` built from a pipelined model.

The model is the ``tiny`` decoder at 4 layers (E 64, 4 heads over 2,
vocab 256, fp32, ``max_seq_len`` 256 so that ``generate()``'s
right-sized cache fits), its weights the reference's dense init carried
by ``models/convert.py``. The reference's ``prepare_pippy`` runs on its
own ``stage 2 x data 4`` mesh over the 8 host devices, with batches whose
microbatch rows divide by its data axis (8 rows in 2 microbatches, and 7
rows padded up to 8).

- ``prepare_pippy`` logits within 2e-5 of the reference's (fp32 through
  four blocks), padded batch included; its refusals.
- ``depipeline`` folds the stages into one stack holding the same
  tensors; ``generate()`` on a pipelined model gives the reference's
  ``generate()`` tokens on its pipelined model, exactly (greedy).
- A ``ServingEngine`` built from the pipelined model serves the same
  greedy tokens as one built from the unpipelined model, on the paged
  and the flat arena.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu import inference as jinf
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.pipeline import remap_params_to_pipeline
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.utils.dataclasses import ShardingConfig as JaxSharding
from accelerate_tpu_torch.generation import depipeline, generate
from accelerate_tpu_torch.inference import PipelinedModel, prepare_pippy
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.serving.engine import ServingEngine

CONFIG = dict(num_layers=4, num_kv_heads=2, max_seq_len=256, attention_impl="xla")
SEQ, NEW = 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, torch's default pool oversubscribes the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The reference's dense weights and every reference result the tests
    read: ``prepare_pippy``'s logits at 8 rows and at 7 (padded to 8), and
    ``generate()``'s greedy tokens on its pipelined model."""
    rs = np.random.RandomState(26)
    ids = rs.randint(0, 256, (8, SEQ)).astype(np.int32)
    prompt = rs.randint(3, 250, (2, 8)).astype(np.int32)
    zeros = jnp.zeros((2, 8), jnp.int32)
    dense = JaxLM(JaxConfig.tiny(**CONFIG, scan_layers=True))
    raw, _ = unbox_params(dense.init(jax.random.PRNGKey(0), zeros)["params"])
    out = {"ids": ids, "prompt": prompt,
           "p0": jax.tree_util.tree_map(np.asarray, raw)}
    JaxState._reset_state(reset_partial_state=True)
    try:
        JaxState(sharding_config=JaxSharding(pipeline_parallel=2, data_parallel=4))
        pipelined = jinf.prepare_pippy((dense, {"params": raw}), num_stages=2,
                                       num_microbatches=2)
        out["pippy"] = np.asarray(pipelined(ids))
        out["pippy_padded"] = np.asarray(pipelined(ids[:7]))
    finally:
        JaxState._reset_state(reset_partial_state=True)
    pipe = JaxLM(JaxConfig.tiny(**CONFIG, pipeline_stages=2, pipeline_microbatches=2))
    template, _ = unbox_params(pipe.init(jax.random.PRNGKey(0), zeros)["params"])
    mapped = remap_params_to_pipeline(raw, template, 2)
    out["tokens"] = np.asarray(jgen.generate(pipe, mapped, jnp.asarray(prompt),
                                             max_new_tokens=NEW))
    return out


def _model(ref, **kw) -> DecoderLM:
    cfg = DecoderConfig.tiny(**CONFIG, **kw)
    return DecoderLM(cfg, device="cpu").load_params(from_reference(ref["p0"], cfg))


# -- prepare_pippy ----------------------------------------------------------


@pytest.mark.parametrize("rows", [8, 7], ids=["whole", "padded"])
def test_prepare_pippy_logits_match_reference(ref, rows):
    pipelined = prepare_pippy(_model(ref), num_stages=2, num_microbatches=2)
    assert isinstance(pipelined, PipelinedModel)
    assert pipelined.model.num_stages == 2
    got = pipelined(torch.from_numpy(ref["ids"][:rows]).long())
    assert got.shape == (rows, SEQ, 256)
    want = ref["pippy" if rows == 8 else "pippy_padded"]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_prepare_pippy_pads_batch_dim_kwargs():
    """A keyword tensor with the batch's leading dimension is padded with
    the batch (copies of row 0), others pass as they are."""
    seen = {}

    class Probe:
        device = torch.device("cpu")

        def __call__(self, ids, **kw):
            seen.update(kw, ids=ids)
            return ids.float()

    got = PipelinedModel(Probe(), 4)(torch.arange(6).reshape(3, 2),
                                     positions=torch.arange(3), scale=torch.ones(2))
    assert got.shape == (3, 2)
    assert seen["ids"][:, 0].tolist() == [0, 2, 4, 0]
    assert seen["positions"].tolist() == [0, 1, 2, 0]
    assert seen["scale"].shape == (2,)


def test_prepare_pippy_refusals(ref):
    model = _model(ref)
    with pytest.raises(ValueError, match="no 'stage' axis"):
        prepare_pippy(model)
    with pytest.raises(ValueError, match="not divisible"):
        prepare_pippy(model, num_stages=3)
    with pytest.raises(TypeError, match="DecoderLM"):
        prepare_pippy(torch.nn.Linear(2, 2), num_stages=2)
    pipelined = prepare_pippy(model, num_stages=2)
    assert pipelined.num_microbatches == 2
    assert pipelined.eval() is pipelined and pipelined.train(False) is pipelined
    with pytest.raises(RuntimeError, match="inference only"):
        pipelined.train()


# -- depipeline and generate() ---------------------------------------------


def test_depipeline_folds_the_stages_onto_the_same_tensors(ref):
    pipe = _model(ref, pipeline_stages=2, pipeline_microbatches=2)
    flat = depipeline(pipe)
    assert flat.num_stages == 1 and flat.config.pipeline_stages == 1
    assert depipeline(flat) is flat
    for (k, a), (_, b) in zip(pipe.named_parameters(), flat.named_parameters()):
        assert a.data_ptr() == b.data_ptr(), k
    ids = torch.from_numpy(ref["ids"]).long()
    with torch.no_grad():
        np.testing.assert_allclose(flat(ids).numpy(), pipe(ids).numpy(), rtol=1e-5, atol=1e-5)


def test_generate_on_a_pipelined_model_matches_reference(ref):
    pipe = _model(ref, pipeline_stages=2, pipeline_microbatches=2)
    got = generate(pipe, torch.from_numpy(ref["prompt"]), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), ref["tokens"])


@pytest.mark.parametrize("page_size", [8, None], ids=["paged", "flat"])
def test_serving_engine_from_a_pipelined_model(ref, page_size):
    prompts = [ref["prompt"][0], ref["prompt"][1, :5], ref["ids"][0, :11]]

    def served(model):
        engine = ServingEngine(model, device="cpu", page_size=page_size, num_slots=2,
                               max_cache_len=64)
        try:
            return engine.generate_batched(prompts, max_new_tokens=NEW)
        finally:
            engine.close()

    want = served(_model(ref))
    got = served(_model(ref, pipeline_stages=2, pipeline_microbatches=2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the reference's generate() continues the shared prompt alike
    np.testing.assert_array_equal(got[0], ref["tokens"][0])
