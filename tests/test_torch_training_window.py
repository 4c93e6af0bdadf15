"""``build_train_step(steps_per_call=2)`` of the port against the JAX
``Accelerator``'s, on the CPU (split from tests/test_torch_training.py,
whose helpers and inputs it shares: the ``tiny`` decoder with GQA 4 -> 2
at seq 256, ``attention_impl="flash"``, fp32 on both sides). Tolerances
are stated where they are used.
"""

import numpy as np
import pytest

import jax
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator, warmup_cosine_decay_schedule
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from test_torch_training import BETAS, CLIP, EPS, LR, SEQ, WD, _cfg, _leaves


WINDOW = 2  # updates per build_train_step(steps_per_call=...) call


def _window_batches():
    """Two calls of a steps_per_call=2 window: [call][update] batches of
    16 x SEQ, each cut into 2 micro-batches of 8."""
    ids = np.random.RandomState(6).randint(0, 256, (2, WINDOW, 16, SEQ)).astype(np.int32)
    return [{"input_ids": ids[c], "labels": ids[c]} for c in range(2)]


@pytest.fixture(scope="module")
def jax_window():
    """The JAX Accelerator's build_train_step(micro_steps=2,
    steps_per_call=2) for two calls (four AdamW updates, clip and a
    warmup-cosine schedule). Returns (initial params, per-call metrics
    (loss, loss_mean, grad_norm), final params)."""
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator()
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash")
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(2), batch_size=8, seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10)
    model, opt = acc.prepare(Model(definition, variables), optax.adamw(
        schedule, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    acc.clip_grad_norm_(max_norm=CLIP)
    step = acc.build_train_step(micro_steps=2, steps_per_call=WINDOW)
    metrics = []
    for batch in _window_batches():
        m = step(batch)
        metrics.append((float(m["loss"]), float(m["loss_mean"]), float(m["grad_norm"])))
    final = jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])
    JaxState._reset_state(reset_partial_state=True)
    return p0, metrics, final


def test_train_step_window_tracks_reference(jax_window):
    """``build_train_step(steps_per_call=2)``: batch leaves carry a leading
    [2] axis and one call runs two full updates (each its own 2-way
    micro-batch split, clip and scheduler step), returning the last
    update's loss and grad_norm plus ``loss_mean``, against the JAX
    Accelerator's fused window. Tolerances as
    ``test_accelerator_tracks_reference``: losses 1e-5 relative, grad
    norms 1e-4 relative, parameters 2e-5 absolute."""
    p0, want, want_final = jax_window
    cfg = _cfg()
    acc = Accelerator(device="cpu")
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(p0, cfg, dtype=torch.float32))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_cosine_decay_schedule(0.0, LR, 2, 10))
    model, opt, sched = acc.prepare(model, opt, sched)
    acc.clip_grad_norm_(max_norm=CLIP)
    step = acc.build_train_step(micro_steps=2, steps_per_call=WINDOW)
    for batch, (loss, loss_mean, norm) in zip(_window_batches(), want):
        m = step(batch)
        np.testing.assert_allclose(m["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(m["loss_mean"].item(), loss_mean, rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), norm, rtol=1e-4)
    assert sched.get_last_lr()[0] == pytest.approx(
        LR * warmup_cosine_decay_schedule(0.0, LR, 2, 10)(2 * WINDOW), rel=1e-12)
    got = to_reference(dict(acc.unwrap_model(model).state_dict()), cfg)
    for (path, w), (_, g) in zip(_leaves(want_final), _leaves(got)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                   err_msg=f"param {jax.tree_util.keystr(path)}")
    with pytest.raises(ValueError, match=r"leading \[2\] axis"):
        step({k: v[0] for k, v in _window_batches()[0].items()})
