"""Pipeline parallelism through the MoE decoder, T5's decoder tower, the
delayed fp8 recipe and the Accelerator, on one process, against the JAX
reference on the CPU.

- MoE (``tiny`` at 4 layers, 4 experts, capacity factor 2.0; S 2, M 2):
  GPipe's loss and router aux against the reference's pipelined forward
  (2e-5 relative), and 1F1B's loss, aux and gradients against its
  ``pipeline_value_and_grad`` (rtol 5e-4, atol 2e-5: the reference's
  ``test_moe_1f1b_matches_ad_grads`` limits).
- T5 (``tiny``, 2 encoder and 4 decoder layers; S 2, M 4): GPipe with a
  source mask (logits 2e-5; loss 1e-5 relative and gradients rtol 2e-4,
  atol 2e-5) and 1F1B without one against the reference's; 1F1B with the
  mask against the port's own GPipe (the reference's 1F1B takes no mask).
- Delayed fp8 under GPipe (S 2, M 2): three ``build_train_step`` updates
  against the JAX ``Accelerator``'s at learning rate 0 (as
  ``test_torch_fp8_models``: the backward's e5m2 flips part the weights
  after a real update), the stage-stacked histories after each to 1e-5
  relative (slot 0 zero after every roll) and the losses to 1e-4.
- The Accelerator: an ``(input_ids, labels)`` batch of a 1F1B model takes
  the schedule (the reference 1F1B update's loss and parameters, 1e-5);
  a batch with another key falls back to GPipe with one warning naming
  the key; fp16, dropout and ``steps_per_call`` compose (1F1B equal to
  GPipe under the same keys over a window of two updates).
"""

import logging

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.models import Seq2SeqConfig as JaxS2SConfig
from accelerate_tpu.models import Seq2SeqLM as JaxS2S
from accelerate_tpu.parallel.pipeline import remap_params_to_pipeline
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, reference_leaves, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig, Seq2SeqLM
from accelerate_tpu_torch.utils.dataclasses import GradScalerKwargs
from accelerate_tpu_torch.utils.random import set_seed

MOE = dict(num_layers=4, moe_num_experts=4, moe_capacity_factor=2.0, attention_impl="xla")
T5 = dict(num_layers=2, num_decoder_layers=4, attention_impl="xla")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, torch's default pool oversubscribes the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pipelined(definition, pipe, zeros_args, stages):
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(
        definition.init(jax.random.PRNGKey(0), *zeros_args)["params"])[0])
    tmpl = unbox_params(jax.eval_shape(
        lambda: pipe.init(jax.random.PRNGKey(0), *zeros_args))["params"])[0]
    return p0, remap_params_to_pipeline(p0, tmpl, stages)


def _check_grads(model, want_tree, rtol, atol):
    got = reference_leaves(to_reference({k: p.grad for k, p in model.named_parameters()},
                                        model.config))
    want = reference_leaves(jax.tree_util.tree_map(np.asarray, want_tree))
    for k, w in want.items():
        k_port = k.replace("pipeline/schedule/stages/layers", "layers")
        np.testing.assert_allclose(got.get(k, got.get(k_port)).reshape(w.shape), w,
                                   rtol=rtol, atol=atol, err_msg=k)


# -- MoE --------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe():
    ids = np.random.RandomState(3).randint(0, 256, (4, 16)).astype(np.int32)
    zeros = jnp.zeros((4, 16), jnp.int32)
    pipe = JaxLM(JaxConfig.tiny(pipeline_stages=2, pipeline_microbatches=2, **MOE))
    p0, pp = _pipelined(JaxLM(JaxConfig.tiny(**MOE)), pipe, (zeros,), 2)
    gpipe = pipe.apply({"params": pp}, ids, labels=ids)
    vag = JaxLM(JaxConfig.tiny(pipeline_stages=2, pipeline_microbatches=2,
                               pipeline_schedule="1f1b", **MOE)).pipeline_value_and_grad()
    out, grads = jax.jit(vag)(pp, ids, ids)
    return {"ids": ids, "p0": p0, "gpipe": gpipe, "1f1b": (out, grads)}


def _moe_model(moe, schedule):
    cfg = DecoderConfig.tiny(pipeline_stages=2, pipeline_microbatches=2,
                             pipeline_schedule=schedule, **MOE)
    return DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(moe["p0"], cfg, dtype=torch.float32))


def test_moe_gpipe_carries_the_router_aux(moe):
    model = _moe_model(moe, "gpipe")
    ids = torch.from_numpy(moe["ids"]).long()
    with torch.no_grad():
        out = model(ids, labels=ids)
    assert out["aux_loss"].item() > 0
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(out[key].item(), float(moe["gpipe"][key]), rtol=2e-5)


def test_moe_1f1b_matches_reference_with_router_aux(moe):
    model = _moe_model(moe, "1f1b")
    ids = torch.from_numpy(moe["ids"]).long()
    out = model.pipeline_value_and_grad()(ids, ids)
    want, grads = moe["1f1b"]
    for key in ("loss", "lm_loss", "aux_loss"):
        np.testing.assert_allclose(out[key].item(), float(want[key]), rtol=2e-5, err_msg=key)
    _check_grads(model, grads, rtol=5e-4, atol=2e-5)


# -- T5's decoder tower -----------------------------------------------------


@pytest.fixture(scope="module")
def t5():
    rs = np.random.RandomState(4)
    src = rs.randint(0, 256, (8, 12)).astype(np.int32)
    tgt = rs.randint(0, 256, (8, 10)).astype(np.int32)
    mask = np.ones((8, 12), np.int32)
    mask[1, 7:] = 0
    mask[6, 3:] = 0
    dense = JaxS2S(JaxS2SConfig.tiny(**T5))
    pipe = JaxS2S(JaxS2SConfig.tiny(pipeline_stages=2, pipeline_microbatches=4, **T5))
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(
        dense.init_variables(jax.random.PRNGKey(0))["params"])[0])
    tmpl = unbox_params(jax.eval_shape(
        lambda: pipe.init_variables(jax.random.PRNGKey(0)))["params"])[0]
    pp = remap_params_to_pipeline(p0, tmpl, 2)
    out = {"src": src, "tgt": tgt, "mask": mask, "p0": p0}
    out["logits"] = np.asarray(pipe.apply({"params": pp}, src, decoder_input_ids=tgt,
                                          attention_mask=mask)["logits"])
    out["gpipe"] = jax.value_and_grad(lambda p: pipe.apply(
        {"params": p}, src, labels=tgt, attention_mask=mask)["loss"])(pp)
    vag = JaxS2S(JaxS2SConfig.tiny(pipeline_stages=2, pipeline_microbatches=4,
                                   pipeline_schedule="1f1b", **T5)).pipeline_value_and_grad()
    out["1f1b"] = jax.jit(vag)(pp, src, tgt)
    return out


def _t5_model(t5, schedule):
    cfg = Seq2SeqConfig.tiny(pipeline_stages=2, pipeline_microbatches=4,
                             pipeline_schedule=schedule, **T5)
    return Seq2SeqLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(t5["p0"], cfg, dtype=torch.float32))


def _t5_inputs(t5):
    return (torch.from_numpy(t5[k]).long() for k in ("src", "tgt", "mask"))


def test_t5_gpipe_with_source_mask_matches_reference(t5):
    model = _t5_model(t5, "gpipe")
    src, tgt, mask = _t5_inputs(t5)
    with torch.no_grad():
        logits = model(src, decoder_input_ids=tgt, attention_mask=mask)["logits"]
    np.testing.assert_allclose(logits.numpy(), t5["logits"], rtol=2e-5, atol=2e-5)
    loss = model(src, labels=tgt, attention_mask=mask)["loss"]
    loss.backward()
    want_loss, want_grads = t5["gpipe"]
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _check_grads(model, want_grads, rtol=2e-4, atol=2e-5)


def test_t5_1f1b_matches_reference(t5):
    model = _t5_model(t5, "1f1b")
    src, tgt, _ = _t5_inputs(t5)
    out = model.pipeline_value_and_grad()(src, tgt)
    want_loss, want_grads = t5["1f1b"]
    np.testing.assert_allclose(out["loss"].item(), float(want_loss), rtol=1e-5)
    _check_grads(model, want_grads, rtol=2e-4, atol=2e-5)


def test_t5_1f1b_with_source_mask_equals_gpipe(t5):
    """The encoder mask rides per microbatch through both schedules: the
    memory's cotangent sums every stage's cross-attention either way."""
    src, tgt, mask = _t5_inputs(t5)
    one_f = _t5_model(t5, "1f1b")
    out = one_f.pipeline_value_and_grad()(src, tgt, attention_mask=mask)
    gpipe = _t5_model(t5, "gpipe")
    loss = gpipe(src, labels=tgt, attention_mask=mask)["loss"]
    loss.backward()
    np.testing.assert_allclose(out["loss"].item(), loss.item(), rtol=1e-6)
    for (k, a), (_, b) in zip(one_f.named_parameters(), gpipe.named_parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# -- delayed fp8 under GPipe -------------------------------------------------


def test_delayed_fp8_histories_under_gpipe_match_reference():
    """Each microbatch reads the histories the ones before it recorded (the
    reference carries them through its belt) and the update rolls them
    once: three updates' histories and losses against the JAX
    Accelerator's."""
    kw = dict(num_layers=4, attention_impl="xla", use_fp8=True, fp8_recipe="delayed",
              fp8_amax_history_len=4, pipeline_stages=2, pipeline_microbatches=2)
    zeros = jnp.zeros((4, 16), jnp.int32)
    jm0 = JaxLM(JaxConfig.tiny(**kw))
    variables = jm0.init(jax.random.PRNGKey(0), zeros)
    params = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    rs = np.random.RandomState(7)
    stats = jax.tree_util.tree_map(
        lambda h: rs.uniform(0.5, 2.0, np.shape(h)).astype(np.float32),
        unbox_params(variables["fp8_stats"])[0])
    JaxState._reset_state(reset_partial_state=True)
    jacc = JaxAccelerator()
    jmodel, _ = jacc.prepare(Model(JaxLM(JaxConfig.tiny(**kw), mesh=jacc.mesh),
                                   {"params": params, "fp8_stats": stats}), optax.sgd(0.0))
    jstep = jacc.build_train_step()

    cfg = DecoderConfig.tiny(**kw)
    acc = Accelerator(device="cpu")
    weights = from_reference({"params": params, **{"fp8_stats": stats}}["params"], cfg,
                             dtype=torch.float32)
    weights.update({k: v for k, v in from_reference(
        {**params, "fp8_stats": stats}, cfg, dtype=torch.float32).items() if k.endswith(
        ("_fp8", "gate", "up", "down"))})
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(weights)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.0))
    step = acc.build_train_step()
    for i in range(3):
        ids = np.random.RandomState(10 + i).randint(0, 256, (4, 16)).astype(np.int32)
        want = float(jstep({"input_ids": ids, "labels": ids})["loss"])
        t = torch.from_numpy(ids).long()
        got = step({"input_ids": t, "labels": t})["loss"].item()
        np.testing.assert_allclose(got, want, rtol=1e-4)
        jh = reference_leaves(jax.tree_util.tree_map(np.asarray, unbox_params(
            dict(jacc._engines[0].extra_state["fp8_stats"]))[0]))
        ph = reference_leaves(to_reference(dict(model.state_dict()), cfg)["fp8_stats"])
        assert sorted(jh) == sorted(ph)
        for k, w in jh.items():
            assert not ph[k][..., 0].any(), k
            np.testing.assert_allclose(ph[k], w, rtol=1e-5, atol=0, err_msg=f"{i} {k}")
    JaxState._reset_state(reset_partial_state=True)


# -- the Accelerator ---------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    ids = np.random.RandomState(1).randint(0, 256, (16, 16)).astype(np.int32)
    zeros = jnp.zeros((16, 16), jnp.int32)
    kw = dict(num_layers=4, attention_impl="xla")
    pipe = JaxLM(JaxConfig.tiny(pipeline_stages=2, pipeline_microbatches=4, **kw))
    p0, pp = _pipelined(JaxLM(JaxConfig.tiny(**kw)), pipe, (zeros,), 2)
    vag = jax.jit(JaxLM(JaxConfig.tiny(pipeline_stages=2, pipeline_microbatches=4,
                                       pipeline_schedule="1f1b", **kw)).pipeline_value_and_grad())
    loss, grads = vag(pp, ids, ids)
    after = jax.tree_util.tree_map(lambda p, g: p - 0.5 * g, pp, grads)
    return {"ids": ids, "p0": p0, "loss": float(loss), "after": after}


def _dense_model(dense, schedule, **kw):
    cfg = DecoderConfig.tiny(num_layers=4, attention_impl="xla", pipeline_stages=2,
                             pipeline_microbatches=4, pipeline_schedule=schedule, **kw)
    return DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(dense["p0"], cfg, dtype=torch.float32))


def test_accelerator_routes_lm_batches_through_1f1b(dense):
    acc = Accelerator(device="cpu")
    model = _dense_model(dense, "1f1b")
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.5))
    ids = torch.from_numpy(dense["ids"]).long()
    m = acc.build_train_step()({"input_ids": ids, "labels": ids})
    assert model.last_schedule is not None
    np.testing.assert_allclose(m["loss"].item(), dense["loss"], rtol=1e-5)
    got = reference_leaves(to_reference(dict(model.named_parameters()), model.config))
    for k, w in reference_leaves(jax.tree_util.tree_map(np.asarray, dense["after"])).items():
        scale = np.abs(w).max()
        assert np.abs(got[k] - w).max() <= 1e-5 * scale, k


def test_extra_batch_key_falls_back_with_one_warning(dense, caplog):
    acc = Accelerator(device="cpu")
    model = _dense_model(dense, "1f1b")
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.5))
    step = acc.build_train_step()
    ids = torch.from_numpy(dense["ids"]).long()
    batch = {"input_ids": ids, "labels": ids, "positions": torch.arange(16)}
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.accelerator"):
        m = step(batch)
        step(batch)
    warned = [r.getMessage() for r in caplog.records if "fallback" in r.getMessage()]
    assert len(warned) == 1 and "positions" in warned[0]
    assert getattr(model, "last_schedule", None) is None  # GPipe ran
    np.testing.assert_allclose(m["loss"].item(), dense["loss"], rtol=1e-5)


def test_fp16_dropout_and_steps_per_call_compose(dense):
    """fp16's scaled seed, the per-(layer, microbatch) dropout masks and a
    window of two updates in one call: 1F1B equals GPipe under the same
    keys, the losses finite and the window's mean reported."""
    def run(schedule):
        set_seed(11)
        acc = Accelerator(mixed_precision="fp16", device="cpu",
                          kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 12)])
        model = _dense_model(dense, schedule, dropout_rate=0.2)
        model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
        step = acc.build_train_step(steps_per_call=2)
        ids = torch.from_numpy(np.stack([dense["ids"], dense["ids"][::-1].copy()])).long()
        m = step({"input_ids": ids, "labels": ids})
        return m, dict(model.named_parameters()), acc.loss_scale.scale

    m1, p1, s1 = run("1f1b")
    mg, pg, sg = run("gpipe")
    assert np.isfinite(m1["loss_mean"].item()) and s1 == sg
    np.testing.assert_allclose(m1["loss"].item(), mg["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m1["loss_mean"].item(), mg["loss_mean"].item(), rtol=1e-5)
    # fp16 rounds each gradient at its cast: per microbatch under 1F1B, per
    # batch under GPipe, so the parameters agree to fp16's unit roundoff
    # (2**-11) of the leaf's largest entry, not fp32's
    for k in p1:
        a, b = p1[k].detach().numpy(), pg[k].detach().numpy()
        assert np.abs(a - b).max() <= 2.0 ** -11 * np.abs(b).max(), k
