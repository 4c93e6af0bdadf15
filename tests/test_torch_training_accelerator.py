"""The port's ``Accelerator`` against the JAX one, on the CPU (split from
tests/test_torch_training.py, whose helpers and inputs it shares: the
``tiny`` decoder with GQA 4 -> 2 at seq 256, ``attention_impl="flash"``,
fp32 on both sides).

AdamW steps through the port's ``Accelerator`` (the eager loop with two
accumulation steps and clipping, then ``build_train_step``) against the
JAX ``Accelerator`` with ``optax.adamw`` on the same data, every
hyperparameter given explicitly on both sides. Tolerances are stated
where they are used.
"""

import numpy as np
import pytest

import jax
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import GradientAccumulationPlugin as JaxAccumulation
from accelerate_tpu import Model
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator, warmup_cosine_decay_schedule
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from test_torch_training import (BETAS, CLIP, EAGER_MICRO, EPS, FUSED_STEPS, LR, SEQ, WD, _cfg,
                                 _data, _leaves)


@pytest.fixture(scope="module")
def jax_training():
    """The JAX Accelerator: eager loop (accumulate / backward / clip / step)
    for 5 updates of 2 micro-batches, then 2 fused steps of 2 micro-batches;
    optax.adamw with a warmup-cosine schedule. Returns (initial params,
    per-micro-step losses, fused (loss, grad_norm), final params)."""
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(gradient_accumulation_plugin=JaxAccumulation(num_steps=2))
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash")
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(1), batch_size=8, seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10)
    model, opt = acc.prepare(Model(definition, variables), optax.adamw(
        schedule, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    ids = _data()
    eager = []
    for i in range(EAGER_MICRO):
        with acc.accumulate(model):
            out = model(input_ids=ids[i], labels=ids[i])
            acc.backward(out["loss"])
            acc.clip_grad_norm_(max_norm=CLIP)
            opt.step()
            opt.zero_grad()
        eager.append(float(out["loss"]))
    step = acc.build_train_step(micro_steps=2)
    fused = []
    for i in range(FUSED_STEPS):
        batch = ids[2 * i: 2 * i + 2].reshape(16, SEQ)
        m = step({"input_ids": batch, "labels": batch})
        fused.append((float(m["loss"]), float(m["grad_norm"])))
    final = jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])
    JaxState._reset_state(reset_partial_state=True)
    return p0, eager, fused, final


def test_accelerator_tracks_reference(jax_training):
    """The same 7 AdamW updates through the port's Accelerator. Tolerances:
    losses 1e-5 relative; grad norms 1e-4 relative; parameters 2e-5
    absolute, against a movement of ~1.3e-2 over the 7 updates (observed
    <= 3.2e-6). Adam divides each gradient entry by its running rms, which
    turns fp32 summation noise in small entries into update noise of up
    to lr * 1e-3, hence the absolute bound on the parameters."""
    p0, want_eager, want_fused, want_final = jax_training
    cfg = _cfg()
    acc = Accelerator(gradient_accumulation_steps=2, device="cpu")
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(p0, cfg, dtype=torch.float32))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_cosine_decay_schedule(0.0, LR, 2, 10))
    ids = _data()
    loader = [{"input_ids": ids[i], "labels": ids[i]} for i in range(EAGER_MICRO)]
    model, opt, sched, loader = acc.prepare(model, opt, sched, loader)
    eager, syncs = [], []
    for batch in loader:
        with acc.accumulate(model):
            loss = model(**batch)["loss"]
            acc.backward(loss)
            acc.clip_grad_norm_(max_norm=CLIP)
            opt.step()
            sched.step()
            opt.zero_grad()
        eager.append(loss.item())
        syncs.append(acc.sync_gradients)
    assert syncs == [False, True] * 5
    np.testing.assert_allclose(eager, want_eager, rtol=1e-5)
    step = acc.build_train_step(micro_steps=2)
    for i in range(FUSED_STEPS):
        batch = ids[2 * i: 2 * i + 2].reshape(16, SEQ)
        m = step({"input_ids": batch, "labels": batch})
        np.testing.assert_allclose(m["loss"].item(), want_fused[i][0], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), want_fused[i][1], rtol=1e-4)
    assert sched.get_last_lr()[0] == pytest.approx(
        LR * warmup_cosine_decay_schedule(0.0, LR, 2, 10)(7), rel=1e-12)
    got = to_reference(dict(acc.unwrap_model(model).state_dict()), cfg)
    for (path, w), (_, g) in zip(_leaves(want_final), _leaves(got)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                   err_msg=f"param {jax.tree_util.keystr(path)}")
    moved = max(np.abs(np.asarray(w) - np.asarray(w0)).max()
                for (_, w), (_, w0) in zip(_leaves(want_final), _leaves(p0)))
    assert moved > 5e-3  # the comparison is not of untouched weights
