"""fp16 training with the dynamic loss scale, the port against the JAX
package's, on the CPU.

- ``mixed_precision="fp16"`` with ``GradScalerKwargs(init_scale=2**24,
  growth_interval=2)``: the first updates overflow (weight gradients reach
  the fp16 masters' cast at up to 2**24 times their size), then the scale
  walks between finite and skipped updates. After every update of the
  eager loop and of ``build_train_step(micro_steps=2,
  steps_per_call=2)``, the port's scale, growth tracker, skipped flag and
  the learning rate the update used equal the JAX ``Accelerator``'s (the
  reference's rate is optax's schedule at its update count, which a
  skipped update leaves where it was), and the parameters agree.
- The ``"scale"`` entry of ``trainer_state.json`` cross-loads both ways.
- :class:`LossScale` replays the reference's rule, the 1.0 floor
  included; the fused step's skipped update leaves every parameter and
  the optimizer's state bitwise; the finite flag's overflow in one
  micro-batch skips the whole window.

``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ 128 with fp32 activations
over fp16-rounded parameters, as the reference computes them on the CPU
(``attention_impl="xla"`` on both sides: the fp16 flash versions are held
in tests/test_torch_fp16_flash.py). Inputs from numpy seeds; tolerances
stated where used.
"""

import json

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
from accelerate_tpu.utils.dataclasses import GradScalerKwargs as JaxGradScalerKwargs
from accelerate_tpu_torch import (Accelerator, GradScalerKwargs, LossScale,
                                  warmup_cosine_decay_schedule)
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM

SEQ, B = 128, 4
LR, BETAS, EPS, WD = 3e-3, (0.9, 0.999), 1e-8, 1e-4
INIT_SCALE, GROWTH = 2.0 ** 24, 2
EAGER, WINDOWS, K, MICRO = 8, 2, 2, 2  # eager updates; fused calls of K updates


def _ids():
    """[update, B, SEQ]: the eager loop's 8, then the fused calls' 4 (each
    cut into 2 micro-batches of 2)."""
    return np.random.RandomState(11).randint(0, 256, (EAGER + WINDOWS * K, B, SEQ)).astype(
        np.int32)


def _schedule_count(opt_state) -> int:
    """optax's schedule count: the last scalar leaf of adamw's chain."""
    counts = [x for x in jax.tree_util.tree_leaves(opt_state) if getattr(x, "ndim", 1) == 0]
    return int(counts[-1])


@pytest.fixture(scope="module")
def reference_walk():
    """The JAX Accelerator in fp16: (initial params, per-update records
    (scale, growth tracker, skipped, lr used), final params)."""
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(mixed_precision="fp16", kwargs_handlers=[JaxGradScalerKwargs(
        init_scale=INIT_SCALE, growth_interval=GROWTH)])
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(4), batch_size=B, seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10)
    model, opt = acc.prepare(Model(definition, variables), optax.adamw(
        schedule, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    engine = acc._engines[0]
    ids = _ids()
    records = []

    def record(lr):
        s = engine.scale_state
        records.append((float(s["scale"]), int(s["growth_tracker"]),
                        bool(acc.optimizer_step_was_skipped), lr))

    for i in range(EAGER):
        lr = float(schedule(_schedule_count(engine.opt_state)))
        with acc.accumulate(model):
            out = model(input_ids=ids[i], labels=ids[i])
            acc.backward(out["loss"])
            opt.step()
            opt.zero_grad()
        record(lr)
    step = acc.build_train_step(micro_steps=MICRO, steps_per_call=K)
    for w in range(WINDOWS):
        lr = float(schedule(_schedule_count(engine.opt_state)))
        batch = ids[EAGER + w * K: EAGER + (w + 1) * K]
        step({"input_ids": batch, "labels": batch})
        record(lr)
    final = jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])
    JaxState._reset_state(reset_partial_state=True)
    return p0, records, final


def _port(p0, **acc_kw):
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(p0, cfg, dtype=torch.float32))
    acc = Accelerator(mixed_precision="fp16", device="cpu", kwargs_handlers=[GradScalerKwargs(
        init_scale=INIT_SCALE, growth_interval=GROWTH)], **acc_kw)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, warmup_cosine_decay_schedule(0.0, LR, 2, 10))
    return (acc, *acc.prepare(model, opt, sched))


def _port_walk(acc, model, opt, sched):
    ids = _ids()
    records = []

    def record(lr):
        s = acc.loss_scale
        records.append((s.scale, s.growth_tracker, acc.optimizer_step_was_skipped, lr))

    for i in range(EAGER):
        lr = opt.param_groups[0]["lr"]
        t = torch.from_numpy(ids[i])
        with acc.accumulate(model):
            acc.backward(model(input_ids=t, labels=t)["loss"])
            opt.step()
            sched.step()
            opt.zero_grad()
        record(lr)
    step = acc.build_train_step(micro_steps=MICRO, steps_per_call=K)
    for w in range(WINDOWS):
        lr = opt.param_groups[0]["lr"]
        batch = ids[EAGER + w * K: EAGER + (w + 1) * K]
        step({"input_ids": batch, "labels": batch})
        record(lr)
    return records


def test_scale_walk_and_parameters_track_reference(reference_walk):
    """Scale, growth tracker and skipped flag exactly; the learning rate
    each update used to 1e-6 relative (optax evaluates the schedule in
    fp32, the port's LambdaLR in fp64); parameters within 1e-4 absolute,
    against a movement of more than 1e-3: Adam turns summation noise into
    update noise of up to lr * 1e-3 (test_torch_training.py's 2e-5 in
    fp32), and here the tied embedding's gradient is summed in fp16 at
    its one cast, rounding at each add (2^-11 relative) in an order XLA's
    scatter and torch's index backward do not share (observed 2.03e-5)."""
    p0, want, want_final = reference_walk
    acc, model, opt, sched = _port(p0)
    got = _port_walk(acc, model, opt, sched)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in want], rtol=1e-6, atol=0)
    # the walk shows both: skipped updates (the first ones) and growth
    assert want[0][2] and not all(r[2] for r in want)
    assert any(b[0] > a[0] for a, b in zip(want, want[1:]))
    final = to_reference(dict(model.state_dict()), model.config)
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(want_final),
                                 jax.tree_util.tree_leaves_with_path(final)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg=f"param {jax.tree_util.keystr(path)}")
    moved = max(np.abs(np.asarray(w) - np.asarray(w0)).max()
                for w, w0 in zip(jax.tree_util.tree_leaves(want_final),
                                 jax.tree_util.tree_leaves(p0)))
    assert moved > 1e-3  # the applied updates moved the weights


# -- the checkpoint's "scale" entry --------------------------------------------


def _jax_fp16(seed):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(mixed_precision="fp16", kwargs_handlers=[JaxGradScalerKwargs(
        init_scale=INIT_SCALE, growth_interval=GROWTH)])
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(seed), batch_size=B, seq_len=SEQ)
    model, opt = acc.prepare(Model(definition, variables), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10), b1=BETAS[0], b2=BETAS[1],
        eps=EPS, weight_decay=WD))
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    return acc, model, opt, p0


def test_scale_entry_cross_loads_both_ways(tmp_path, monkeypatch):
    """The port writes the reference's ``"scale": {"scale",
    "growth_tracker"}`` (floats) into each engine entry, the reference
    loads it; the reference's entry loads into the port's scale."""
    ids = _ids()
    jacc, jmodel, jopt, p0 = _jax_fp16(4)
    acc, model, opt, sched = _port(p0)
    for i in range(5):  # 4 overflows, then a finite update: scale 2^20, tracker 1
        t = torch.from_numpy(ids[i])
        with acc.accumulate(model):
            acc.backward(model(input_ids=t, labels=t)["loss"])
            opt.step()
            sched.step()
            opt.zero_grad()
    want = acc.loss_scale.state_dict()
    assert want["scale"] < INIT_SCALE and want["growth_tracker"] == 1
    port_dir = str(tmp_path / "port")
    acc.save_state(port_dir)
    meta = json.load(open(f"{port_dir}/trainer_state.json"))["engines"][0]
    assert meta["scale"] == {"scale": want["scale"], "growth_tracker": 1.0}
    jacc.load_state(port_dir)
    s = jacc._engines[0].scale_state
    assert (float(s["scale"]), int(s["growth_tracker"])) == (want["scale"], 1)

    # the reference's file, into a port accelerator at its initial scale
    s = {"scale": np.float32(2.0 ** 13), "growth_tracker": np.int32(1)}
    jacc._engines[0].scale_state = {k: jax.numpy.asarray(v) for k, v in s.items()}
    ref_dir = str(tmp_path / "reference")
    monkeypatch.setattr("accelerate_tpu.checkpointing._is_sharded_tree", lambda tree: False)
    jacc.save_state(ref_dir)
    JaxState._reset_state(reset_partial_state=True)
    acc2, *_ = _port(p0)
    assert acc2.loss_scale.state_dict() == {"scale": INIT_SCALE, "growth_tracker": 0}
    acc2.load_state(ref_dir)
    assert acc2.loss_scale.state_dict() == {"scale": 2.0 ** 13, "growth_tracker": 1}


# -- the rule and the skip ----------------------------------------------------


def test_loss_scale_replays_the_reference_rule():
    """Growth after ``growth_interval`` finite updates in a row, backoff
    on a non-finite one with a floor of 1.0 (torch's GradScaler has none),
    in fp32 arithmetic, on a random sequence of finite flags."""
    rule = GradScalerKwargs(init_scale=4.0, growth_factor=3.0, backoff_factor=0.25,
                            growth_interval=3)
    scale = LossScale(rule)
    ref_scale, tracker = np.float32(4.0), 0
    flags = np.random.RandomState(0).rand(200) < 0.7
    floored = False
    for finite in flags:
        scale.update(bool(finite))
        if finite:
            tracker += 1
            if tracker >= rule.growth_interval:
                ref_scale, tracker = np.float32(ref_scale * np.float32(3.0)), 0
        else:
            ref_scale = max(np.float32(ref_scale * np.float32(0.25)), np.float32(1.0))
            floored |= ref_scale == 1.0
            tracker = 0
        assert (scale.scale, scale.growth_tracker) == (float(ref_scale), tracker)
    assert floored


def _small_model(seed):
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ)
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32)
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    return model


def test_skipped_fused_update_leaves_parameters_and_moments_bitwise():
    """build_train_step from a scale that overflows: the update is
    skipped (parameters, Adam's moments and step untouched, the LR
    schedule not advanced), the update counter advances, the scale backs
    off; an overflow in one of two micro-batches skips the update too."""
    acc = Accelerator(mixed_precision="fp16", device="cpu",
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 100)])
    model = _small_model(0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0 / (k + 1))
    model, opt, sched = acc.prepare(model, opt, sched)
    ids = _ids()[:2].reshape(2 * B, SEQ)
    batch = {"input_ids": ids, "labels": ids}
    poison, calls = [False], []

    def loss_fn(m, mb):
        """The second micro-batch's loss x 1e30 when poisoned: its
        gradients overflow whatever the scale."""
        calls.append(1)
        loss = m(**mb)["loss"]
        return loss * 1e30 if poison[0] and len(calls) % 2 == 0 else loss

    step = acc.build_train_step(loss_fn=loss_fn, micro_steps=2)
    step(batch)  # skipped: Adam has no state yet
    assert acc.optimizer_step_was_skipped and opt.step_count == 1
    assert not opt.optimizer.state and sched.scheduler.last_epoch == 0
    assert acc.loss_scale.state_dict() == {"scale": 2.0 ** 99, "growth_tracker": 0}
    acc.loss_scale.scale = 2.0 ** 8  # finite: one applied update
    step(batch)
    assert not acc.optimizer_step_was_skipped and sched.scheduler.last_epoch == 1
    moments = [st["exp_avg"].clone() for st in opt.optimizer.state.values()]
    snap = [p.detach().clone() for p in model.parameters()]
    lr = opt.param_groups[0]["lr"]
    poison[0] = True
    step(batch)
    assert acc.optimizer_step_was_skipped and opt.step_count == 3
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), snap))
    assert all(torch.equal(st["exp_avg"], m)
               for st, m in zip(opt.optimizer.state.values(), moments))
    assert opt.param_groups[0]["lr"] == lr and sched.scheduler.last_epoch == 1
    assert acc.loss_scale.state_dict() == {"scale": 2.0 ** 7, "growth_tracker": 0}


def test_eager_accumulation_window_skips_on_one_bad_micro_batch():
    """With two accumulation steps, a non-finite gradient in the first
    micro-batch skips the window's update though the second is finite;
    the finite flag is read once, at the update."""
    acc = Accelerator(mixed_precision="fp16", gradient_accumulation_steps=2, device="cpu",
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 8)])
    model = _small_model(1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model, opt = acc.prepare(model, opt)
    ids = torch.from_numpy(_ids()[0])
    snap = [p.detach().clone() for p in model.parameters()]
    for factor, sync in ((1e30, False), (1.0, True)):
        with acc.accumulate(model):
            acc.backward(model(input_ids=ids, labels=ids)["loss"] * factor)
            assert acc.sync_gradients == sync
            opt.step()
            opt.zero_grad()
    assert acc.optimizer_step_was_skipped and opt.step_count == 1
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), snap))
    assert acc.loss_scale.state_dict() == {"scale": 2.0 ** 7, "growth_tracker": 0}
    # the next window is finite: applied, the tracker counts it
    for _ in range(2):
        with acc.accumulate(model):
            acc.backward(model(input_ids=ids, labels=ids)["loss"])
            opt.step()
            opt.zero_grad()
    assert not acc.optimizer_step_was_skipped and opt.step_count == 2
    assert not all(torch.equal(p, q) for p, q in zip(model.parameters(), snap))
    assert acc.loss_scale.state_dict() == {"scale": 2.0 ** 7, "growth_tracker": 1}
