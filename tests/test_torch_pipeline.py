"""Pipeline parallelism on one process (``parallel/pipeline.py``, an
explicit ``pipeline_stages``, the local handoff) against the JAX
reference's pipelined ``DecoderLM`` on the CPU.

The model is the ``tiny`` decoder at 4 layers (E 64, 4 heads, vocab 256,
fp32, plain attention on both sides); its weights are the reference's
dense init, laid out for the reference's pipelined tree by its
``remap_params_to_pipeline`` and carried to the port by
``models/convert.py``. The batch is 16 x 16.

- The strided microbatch helpers against the reference's.
- GPipe: logits at (S, M) = (2, 2) and (2, 4) within 2e-5; loss (1e-5
  relative) and every gradient leaf (rtol 2e-4, atol 2e-5: the
  reference's own limits) against ``jax.value_and_grad`` of the
  reference's pipelined loss.
- 1F1B against the reference's ``pipeline_value_and_grad``: plain, with
  uneven -100 padding across microbatches, and with an fp16 loss scale
  seeding the backward (the gradients come back scaled), the same limits.
- Dropout, held inside the port (threefry has no torch counterpart): 1F1B
  equals GPipe under the same keys, and a sequential replay of each
  (layer, microbatch)'s mask; with dropout off (eval) two runs agree.
- Memory: 1F1B's live saved activations at M 8 stay below GPipe's, and
  its stash holds at most 2S - 1 microbatch inputs at M 8 and at M 16.
"""

import numpy as np
import pytest

import jax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel import pipeline as jax_pipeline
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, reference_leaves, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.parallel import pipeline
from accelerate_tpu_torch.utils.random import set_seed

B, S_LEN = 16, 16
CONFIG = dict(num_layers=4, attention_impl="xla")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, torch's default pool oversubscribes the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_pipe(**kw):
    return JaxLM(JaxConfig.tiny(**CONFIG, **kw))


@pytest.fixture(scope="module")
def ref():
    """The reference's dense init, its pipelined layouts, the batch, and
    every reference result the tests read."""
    ids = np.random.RandomState(1).randint(0, 256, (B, S_LEN)).astype(np.int32)
    zeros = jax.numpy.zeros((B, S_LEN), jax.numpy.int32)
    dense = JaxLM(JaxConfig.tiny(**CONFIG))
    p0 = jax.tree_util.tree_map(
        np.asarray, unbox_params(dense.init(jax.random.PRNGKey(0), zeros)["params"])[0])
    out = {"ids": ids, "p0": p0}
    for stages, micro in ((2, 2), (2, 4)):
        pipe = _jax_pipe(pipeline_stages=stages, pipeline_microbatches=micro)
        tmpl = unbox_params(jax.eval_shape(
            lambda: pipe.init(jax.random.PRNGKey(0), zeros))["params"])[0]
        pp = jax_pipeline.remap_params_to_pipeline(p0, tmpl, stages)
        out[("logits", stages, micro)] = np.asarray(pipe.apply({"params": pp}, ids)["logits"])
        out[("pp", stages)] = pp
    pp = out[("pp", 2)]
    pipe = _jax_pipe(pipeline_stages=2, pipeline_microbatches=4)
    out["gpipe"] = jax.value_and_grad(
        lambda p: pipe.apply({"params": p}, ids, labels=ids)["loss"])(pp)
    vag = jax.jit(_jax_pipe(pipeline_stages=2, pipeline_microbatches=4,
                            pipeline_schedule="1f1b").pipeline_value_and_grad())
    padded = ids.copy()
    padded[::3, 6:] = -100
    padded[1, 2:] = -100
    out["padded"] = padded
    out["1f1b"] = vag(pp, ids, ids)
    out["1f1b_padded"] = vag(pp, ids, padded)
    out["1f1b_scaled"] = vag(pp, ids, ids, scale=128.0)
    return out


def _model(ref, **kw) -> DecoderLM:
    cfg = DecoderConfig.tiny(**CONFIG, **kw)
    return DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(ref["p0"], cfg, dtype=torch.float32))


def _grads(model) -> dict:
    cfg = model.config
    return reference_leaves(to_reference({k: p.grad for k, p in model.named_parameters()}, cfg))


def _check_grads(got: dict, want_tree, rtol=2e-4, atol=2e-5):
    want = reference_leaves(jax.tree_util.tree_map(np.asarray, want_tree))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def _ids(ref, key="ids"):
    return torch.from_numpy(ref[key]).long()


# -- the helpers ------------------------------------------------------------


def test_split_merge_roundtrip_matches_reference():
    x = np.arange(48.0, dtype=np.float32).reshape(12, 4)
    mb = pipeline.split_microbatches(torch.from_numpy(x), 4)
    assert mb.shape == (4, 3, 4)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jax_pipeline.split_microbatches(x, 4)))
    np.testing.assert_array_equal(pipeline.merge_microbatches(mb).numpy(), x)
    np.testing.assert_array_equal(pipeline.merge_microbatches(list(mb.unbind(0))).numpy(), x)


def test_split_indivisible_raises():
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.split_microbatches(torch.zeros(10, 2), 4)


def test_odd_batch_adapts_microbatches(ref, caplog):
    """A batch of 6 with 4 microbatches configured runs at M 3 (the
    largest that divides it), with one warning, and its logits equal the
    reference's pipelined model on the same rows, which adapts alike."""
    assert pipeline.adapt_microbatches(6, 4, 2) == 3
    assert pipeline.adapt_microbatches(1, 4, 2) == 1
    model = _model(ref, pipeline_stages=2, pipeline_microbatches=4)
    ids = ref["ids"][:6]
    with caplog.at_level("WARNING"), torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    assert any("M=3" in r.getMessage() for r in caplog.records)
    want = _jax_pipe(pipeline_stages=2, pipeline_microbatches=4).apply(
        {"params": ref[("pp", 2)]}, ids)["logits"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_config_fields_and_refusals():
    cfg = DecoderConfig.tiny(num_layers=4, pipeline_stages=2)
    assert cfg.pipeline_microbatches is None and cfg.pipeline_schedule == "gpipe"
    with pytest.raises(ValueError, match="divide"):
        DecoderConfig.tiny(num_layers=3, pipeline_stages=2)
    with pytest.raises(ValueError, match="pipeline_schedule"):
        DecoderConfig.tiny(num_layers=4, pipeline_schedule="zb")
    # the reference's refusal, kept
    with pytest.raises(NotImplementedError, match="1f1b schedule"):
        DecoderConfig.tiny(num_layers=4, use_fp8=True, fp8_recipe="delayed",
                           pipeline_stages=2, pipeline_schedule="1f1b")
    model = DecoderLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="depipeline"):
        model(torch.zeros(1, 4, dtype=torch.long), cache=model.init_cache(1, 8))
    # gpipe has no manual value-and-grad, nor does an unpipelined 1f1b config
    assert model.pipeline_value_and_grad() is None
    assert DecoderLM(DecoderConfig.tiny(num_layers=4, pipeline_schedule="1f1b"),
                     device="cpu").pipeline_value_and_grad() is None


# -- GPipe ------------------------------------------------------------------


@pytest.mark.parametrize("stages,micro", [(2, 2), (2, 4)])
def test_gpipe_logits_match_reference(ref, stages, micro):
    model = _model(ref, pipeline_stages=stages, pipeline_microbatches=micro)
    with torch.no_grad():
        got = model(_ids(ref)).numpy()
    np.testing.assert_allclose(got, ref[("logits", stages, micro)], rtol=2e-5, atol=2e-5)


def test_gpipe_loss_and_grads_match_reference(ref):
    model = _model(ref, pipeline_stages=2, pipeline_microbatches=4)
    loss = model(_ids(ref), labels=_ids(ref))["loss"]
    loss.backward()
    want_loss, want_grads = ref["gpipe"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _check_grads(_grads(model), want_grads)


# -- 1F1B -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "padded", "scaled"])
def test_1f1b_matches_reference(ref, case):
    """The port's 1F1B value-and-grad against the reference's: the loss and
    every gradient leaf. ``padded``: uneven -100 padding across
    microbatches (each microbatch's CE weighted by its share of the global
    count); ``scaled``: an fp16 loss scale of 128 seeds the backward and
    the gradients come back scaled, as the reference's."""
    model = _model(ref, pipeline_stages=2, pipeline_microbatches=4, pipeline_schedule="1f1b")
    vag = model.pipeline_value_and_grad()
    labels = _ids(ref, "padded" if case == "padded" else "ids")
    out = vag(_ids(ref), labels, scale=128.0 if case == "scaled" else None)
    want_loss, want_grads = ref[{"plain": "1f1b", "padded": "1f1b_padded",
                                 "scaled": "1f1b_scaled"}[case]]
    np.testing.assert_allclose(out["loss"].item(), float(want_loss), rtol=1e-5)
    scale = 128.0 if case == "scaled" else 1.0
    _check_grads(_grads(model), want_grads, atol=2e-5 * scale)
    # the head ran on the last stage's valid ticks only, one per microbatch
    assert model.last_schedule.heads == [0, 1, 2, 3]
    assert len(model.last_schedule.forwards) == len(model.last_schedule.backwards) == 2 * 4


# -- dropout ----------------------------------------------------------------


def _dropout_model(ref, schedule, **kw):
    model = _model(ref, pipeline_stages=2, pipeline_microbatches=4, pipeline_schedule=schedule,
                   dropout_rate=0.2, **kw)
    return model.train()


def _run(model, ids, seed=5):
    set_seed(seed)
    if model.config.pipeline_schedule == "1f1b":
        loss = model.pipeline_value_and_grad()(ids, ids)["loss"]
    else:
        loss = model(ids, labels=ids)["loss"]
        loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_1f1b_dropout_equals_gpipe_under_the_same_keys(ref):
    ids = _ids(ref)
    l1, g1 = _run(_dropout_model(ref, "1f1b"), ids)
    lg, gg = _run(_dropout_model(ref, "gpipe"), ids)
    l0, _ = _run(_model(ref, pipeline_stages=2, pipeline_microbatches=4), ids)
    assert abs(l1 - l0) > 1e-3  # the masks bite
    np.testing.assert_allclose(l1, lg, rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), gg[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_1f1b_dropout_equals_sequential_replay(ref):
    """Each microbatch run alone through the four blocks with the masks
    of its (layer, microbatch) keys, then the head, summed by autograd:
    the 1F1B gradients must equal it, which holds only if every
    rematerialized forward drew its forward's masks."""
    from accelerate_tpu_torch.ops.layers import rms_norm, rotary_embedding_tables
    from accelerate_tpu_torch.ops.losses import fused_linear_cross_entropy_parts
    from accelerate_tpu_torch.utils.random import next_key

    ids = _ids(ref)
    l1, g1 = _run(_dropout_model(ref, "1f1b"), ids)
    model = _dropout_model(ref, "gpipe")
    cfg = model.config
    set_seed(5)
    key = next_key("dropout")
    sin, cos = rotary_embedding_tables(torch.arange(S_LEN), cfg.head_dim, theta=cfg.rope_theta,
                                       dtype=cfg.dtype)
    ids_mb = pipeline.split_microbatches(ids, 4)
    count = (ids_mb[:, :, 1:] != -100).sum().float()
    total = 0.0
    for m in range(4):
        x = model.embedding[ids_mb[m]]
        for i, block in enumerate(model.layers):
            x, _ = block(x, sin, cos, drop=(*key, i + cfg.num_layers * m))
        h = rms_norm(x, model.ln_final, cfg.norm_eps)
        t, _ = fused_linear_cross_entropy_parts(
            h[:, :-1].reshape(-1, cfg.embed_dim), model.embedding.t(),
            ids_mb[m][:, 1:].reshape(-1), ignore_index=-100, num_chunks=cfg.fused_ce_chunks)
        total = total + t
    (total / count).backward()
    np.testing.assert_allclose(l1, (total / count).item(), rtol=1e-6)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(g1[k].numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_1f1b_without_dropout_is_deterministic(ref):
    """In eval mode no mask is drawn: two runs agree bit for bit, and with
    the undropped model's."""
    ids = _ids(ref)
    a = _run(_dropout_model(ref, "1f1b").eval(), ids, seed=1)
    b = _run(_dropout_model(ref, "1f1b").eval(), ids, seed=2)
    c = _run(_model(ref, pipeline_stages=2, pipeline_microbatches=4,
                    pipeline_schedule="1f1b"), ids)
    assert a[0] == b[0] == c[0]
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]) and torch.equal(a[1][k], c[1][k]), k


# -- memory -----------------------------------------------------------------


class _Saved:
    """Bytes of the tensors autograd keeps for a backward, live and at
    their peak (``saved_tensors_hooks``: a packed tensor counts until its
    graph is freed)."""

    def __init__(self):
        self.live = self.peak = 0

    def pack(self, t):
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        return _Held(self, t, n)

    @staticmethod
    def unpack(h):
        return h.t


class _Held:
    def __init__(self, saved, t, n):
        self.saved, self.t, self.n = saved, t, n

    def __del__(self):
        self.saved.live -= self.n


def _peak_saved(ref, schedule: str, micro: int, batch: int) -> tuple:
    model = _model(ref, pipeline_stages=2, pipeline_microbatches=micro, pipeline_schedule=schedule)
    ids = torch.from_numpy(np.resize(ref["ids"], (batch, S_LEN))).long()
    saved = _Saved()
    with torch.autograd.graph.saved_tensors_hooks(saved.pack, saved.unpack):
        if schedule == "1f1b":
            model.pipeline_value_and_grad()(ids, ids)
        else:
            model(ids, labels=ids)["loss"].backward()
    return saved.peak, getattr(model, "last_schedule", None)


def test_1f1b_saved_activations_below_gpipe(ref):
    """At M 8 GPipe keeps every microbatch's activations until its one
    backward; 1F1B keeps one stage-microbatch's graph at a time (and the
    embedding's), so its peak of saved bytes is well below."""
    gpipe, _ = _peak_saved(ref, "gpipe", 8, 32)
    one_f, stats = _peak_saved(ref, "1f1b", 8, 32)
    assert one_f < gpipe / 2, (one_f, gpipe)
    assert stats.max_stash <= 2 * 2 - 1
    _, stats16 = _peak_saved(ref, "1f1b", 16, 32)
    assert stats16.max_stash == stats.max_stash  # O(S), whatever M is
