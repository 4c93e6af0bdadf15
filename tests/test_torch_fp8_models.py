"""The fp8 recipe through the port's models against the JAX package's, on
the CPU: the tiny decoder, BERT and T5 at ``dtype=float32`` under both
recipes.

- Loss, logits, every gradient leaf and one AdamW update (eps and weight
  decay given on both sides), and under the delayed recipe the histories
  one training forward leaves, against the reference's ``apply`` with the
  ``fp8_stats`` collection mutable. The delayed histories start from
  numpy-seeded positive values on both sides (warm scales).
- Given the same scales, both sides quantize to the same bytes
  (tests/test_torch_fp8.py), so the forward agrees to fp32 noise: loss,
  logits and histories are held there. The backward quantizes each
  product's incoming gradient to e5m2 under current scaling, whose scale
  is the tensor's own amax: fp32 noise (~1e-7) in a gradient can move one
  value across an e5m2 rounding boundary (one step is 2^-2 relative)
  and, where that value is the amax, every value of that tensor, so
  every gradient upstream of it moves by up to a step's share. A
  gradient leaf off by more than fp32 noise is held to that step and to
  the exact (no fp8) gradient: the port's must be as close to it as the
  reference's (observed in T5's encoder under current scaling: 0.2527
  against 0.2531 relative; the other leaves and families agree to ~1e-6).
- Three ``build_train_step`` updates of two micro-batches under the
  delayed recipe against the JAX ``Accelerator`` on its 8-device CPU mesh:
  the histories after each (slot 0 zero after every roll, the rest the
  reference's to 1e-5 relative) and the losses.

Inputs are numpy arrays from seeds.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import DecoderConfig as JaxDecoderConfig
from accelerate_tpu.models import DecoderLM as JaxDecoderLM
from accelerate_tpu.models import EncoderClassifier as JaxClassifier
from accelerate_tpu.models import EncoderConfig as JaxEncoderConfig
from accelerate_tpu.models.seq2seq import Seq2SeqConfig as JaxSeq2SeqConfig
from accelerate_tpu.models.seq2seq import Seq2SeqLM as JaxSeq2SeqLM
from accelerate_tpu.ops import fp8 as ref_fp8
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import EncoderClassifier, EncoderConfig
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import (from_reference, random_params,
                                                 reference_leaves, to_reference)
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig, Seq2SeqLM
from accelerate_tpu_torch.ops import fp8

B, S = 8, 16
HIST = 4
# eps 1e-6: test_torch_seq2seq.py says why (Adam's first update at |g| ~ eps)
LR, BETAS, EPS, WD = 3e-3, (0.9, 0.999), 1e-6, 1e-4
# fp32 noise: loss relative, a gradient leaf against its largest entry
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
# one e5m2 step: the widest a gradient entry moves when a backward
# quantization flips one value (relative to the leaf's largest entry)
E5M2_STEP = 2.0 ** -2


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


class Family:
    """One model family on both sides: configs, the batch and the loss."""

    def __init__(self, name, jax_model, port_model, jax_config, port_config, batch, call):
        self.name, self.jax_model, self.port_model = name, jax_model, port_model
        self.jax_config, self.port_config = jax_config, port_config
        self.batch, self.call = batch, call


def _decoder_batch(seed):
    ids = np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[1, :5] = -100
    return {"input_ids": ids, "labels": labels}


def _bert_batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 256, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    mask[2, 4:] = 0
    types = (np.arange(S)[None, :] >= rng.randint(2, S, (B, 1))).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": types,
            "labels": rng.randint(0, 2, (B,)).astype(np.int32)}


def _t5_batch(seed):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 256, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    labels = rng.randint(3, 256, (B, 12)).astype(np.int32)
    labels[0, :3] = -100
    return {"input_ids": src, "attention_mask": mask, "labels": labels}


FAMILIES = {
    "decoder": Family(
        "decoder", JaxDecoderLM, DecoderLM,
        lambda **kw: JaxDecoderConfig.tiny(num_kv_heads=2, max_seq_len=S,
                                           attention_impl="xla", **kw),
        lambda **kw: DecoderConfig.tiny(num_kv_heads=2, max_seq_len=S, attention_impl="xla",
                                        **kw),
        _decoder_batch, None),
    "bert": Family(
        "bert", JaxClassifier, EncoderClassifier,
        lambda **kw: JaxEncoderConfig.tiny(dropout_rate=0.0, max_seq_len=S, **kw),
        lambda **kw: EncoderConfig.tiny(dropout_rate=0.0, max_seq_len=S, **kw),
        _bert_batch, None),
    "t5": Family(
        "t5", JaxSeq2SeqLM, Seq2SeqLM,
        lambda **kw: JaxSeq2SeqConfig.tiny(max_seq_len=S, max_target_len=S, **kw),
        lambda **kw: Seq2SeqConfig.tiny(max_seq_len=S, max_target_len=S, **kw),
        _t5_batch, None),
}


def _init(fam: Family, recipe: str):
    """(JAX model, params, warm fp8_stats or None) as numpy trees."""
    jm = fam.jax_model(fam.jax_config(use_fp8=True, fp8_recipe=recipe,
                                      fp8_amax_history_len=HIST))
    kw = {"target_len": 12} if fam.name == "t5" else {}
    variables = jm.init_variables(jax.random.PRNGKey(0), batch_size=2, seq_len=S, **kw)
    params = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    stats = None
    if recipe == "delayed":
        rs = np.random.RandomState(11)
        stats = jax.tree_util.tree_map(
            lambda x: (np.abs(rs.standard_normal(np.shape(x))) * 2 + 0.5).astype(np.float32),
            unbox_params(dict(variables["fp8_stats"]))[0])
    return jm, params, stats


def _port(fam: Family, recipe: str, params, stats):
    cfg = fam.port_config(use_fp8=True, fp8_recipe=recipe, fp8_amax_history_len=HIST)
    flat = dict(reference_leaves(params))
    if stats is not None:
        flat.update({"fp8_stats/" + k: v for k, v in reference_leaves(stats).items()})
    return fam.port_model(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(flat, cfg, dtype=torch.float32))


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "labels" else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_apply(jm, params, stats, batch):
    """The reference's training forward: the fp8_stats collection mutable,
    as its TrainEngine applies it. Returns (outputs, new collections)."""
    variables = {"params": params}
    if stats is not None:
        variables["fp8_stats"] = jax.tree_util.tree_map(jnp.asarray, stats)
    return jm.apply(variables, **{k: jnp.asarray(v) for k, v in batch.items()},
                    mutable=["fp8_stats"])


def _jax_loss(jm, params, stats, batch):
    out, new = _jax_apply(jm, params, stats, batch)
    return out["loss"], new.get("fp8_stats")


@pytest.mark.parametrize("recipe", ["current", "delayed"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_grads_histories_and_update_match_reference(family, recipe):
    """Loss 1e-5 relative (BERT's logits 1e-5 of their largest too), the
    delayed histories a training forward leaves 1e-6 relative; each
    gradient leaf within 1e-4 of its largest entry, or, where a backward
    flip decoupled it (see the module's docstring), within one e5m2 step
    (2^-2) of its largest entry and as close to the exact gradient as the
    reference's (1.05x its distance); one AdamW update from the port's
    gradients equal to optax.adamw's from the same gradients (2e-5
    absolute)."""
    fam = FAMILIES[family]
    jm, params, stats = _init(fam, recipe)
    batch = fam.batch(0)
    (want_loss, new_stats), want_grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jm, p, stats, batch), has_aux=True))(params)
    model = _port(fam, recipe, params, stats)
    out = model(**_torch_batch(batch))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(want_loss), rtol=LOSS_RTOL)
    if family == "bert":
        want_logits = jax.jit(lambda p: _jax_apply(jm, p, stats, batch)[0]["logits"])(params)
        w = np.asarray(want_logits)
        np.testing.assert_allclose(out["logits"].detach().numpy(), w, rtol=0,
                                   atol=LOSS_RTOL * np.abs(w).max())
    if recipe == "delayed":
        got = to_reference(dict(model.state_dict()), model.config)["fp8_stats"]
        for (path, w), (_, g) in zip(_leaves(unbox_params(dict(new_stats))[0]), _leaves(got)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=0,
                                       err_msg=f"history {jax.tree_util.keystr(path)}")
    grads = to_reference({n: p.grad for n, p in model.named_parameters()}, model.config)
    exact = None
    for (path, w), (_, g) in zip(_leaves(want_grads), _leaves(grads)):
        w, top = np.asarray(w), np.abs(np.asarray(w)).max()
        if np.abs(g - w).max() <= GRAD_RTOL * top:
            continue
        if exact is None:
            exact = dict(_leaves(_exact_grads(fam, params, batch)))
        e = np.asarray(exact[path])
        where = f"grad {jax.tree_util.keystr(path)}"
        assert np.abs(g - w).max() <= E5M2_STEP * top, where
        assert np.linalg.norm(g - e) <= 1.05 * np.linalg.norm(w - e), where
    # one AdamW update from the port's gradients, on both sides
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    opt.step()
    tx = optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    got = to_reference({n: p for n, p in model.named_parameters()}, model.config)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0,
                                   err_msg=f"param {jax.tree_util.keystr(path)}")


def _exact_grads(fam: Family, params, batch):
    """The reference's gradients without fp8: the yardstick of its own fp8
    error."""
    jm = fam.jax_model(fam.jax_config())
    return jax.jit(jax.grad(lambda p: _jax_loss(jm, p, None, batch)[0]))(params)


# -- the Accelerator ------------------------------------------------------------


def _jax_accelerator(fam: Family, params, stats, lr=LR, **kw):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(**kw)
    jm = fam.jax_model(fam.jax_config(use_fp8=True, fp8_recipe="delayed",
                                      fp8_amax_history_len=HIST), mesh=acc.mesh)
    model, _ = acc.prepare(Model(jm, {"params": params, "fp8_stats": stats}),
                           optax.adamw(lr, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    return acc, model


def _jax_histories(acc):
    return jax.tree_util.tree_map(np.asarray, unbox_params(
        dict(acc._engines[0].extra_state["fp8_stats"]))[0])


def _port_accelerator(fam: Family, params, stats, lr=LR, **kw):
    acc = Accelerator(device="cpu", **kw)
    model = _port(fam, "delayed", params, stats)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=BETAS, eps=EPS, weight_decay=WD)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt


def _histories(model):
    return to_reference(dict(model.state_dict()), model.config)["fp8_stats"]


def _two_batches(fam: Family, seed: int):
    a, b = fam.batch(seed), fam.batch(seed + 100)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_histories_after_accumulated_updates_match_reference(family):
    """Three build_train_step updates of two micro-batches each (the
    micro-batches share the current slot, the update rolls it): slot 0 is
    zero after every update, the histories are the JAX Accelerator's to
    1e-5 relative, the losses to 1e-4 (bit for bit at most updates; T5's
    second batch holds one value at an e4m3 rounding boundary within fp32
    noise, whose one-step flip moves that loss 1.5e-5). At learning rate 0 the weights stay
    equal on both sides, so what is compared is the histories' bookkeeping:
    after a real update the two sides' weights part by the backward's fp8
    flips (see the module's docstring), which one update's comparison
    above holds."""
    fam = FAMILIES[family]
    _, params, stats = _init(fam, "delayed")
    jacc, _ = _jax_accelerator(fam, params, stats, lr=0.0)
    jstep = jacc.build_train_step(micro_steps=2)
    acc, model, _ = _port_accelerator(fam, params, stats, lr=0.0)
    step = acc.build_train_step(micro_steps=2)
    for i in range(3):
        batch = _two_batches(fam, i)
        want = float(jstep(batch)["loss"])
        got = step(_torch_batch(batch))["loss"].item()
        np.testing.assert_allclose(got, want, rtol=1e-4)
        for (path, w), (_, g) in zip(_leaves(_jax_histories(jacc)), _leaves(_histories(model))):
            assert not g[..., 0].any()
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg=f"update {i} {jax.tree_util.keystr(path)}")
    JaxState._reset_state(reset_partial_state=True)


def test_user_loss_fn_leaves_histories_as_they_were():
    """The reference's user loss_fn forwards discard their amax writes and
    its update does not roll: the histories stay as they were, on both
    sides; the default path moves them."""
    fam = FAMILIES["decoder"]
    _, params, stats = _init(fam, "delayed")
    batch = _two_batches(fam, 0)
    jacc, _ = _jax_accelerator(fam, params, stats)
    before = _jax_histories(jacc)
    jstep = jacc.build_train_step(
        loss_fn=lambda apply_fn, p, b: apply_fn(p, b["input_ids"], labels=b["labels"])["loss"],
        micro_steps=2)
    jstep(batch)
    for (_, w), (_, v) in zip(_leaves(before), _leaves(_jax_histories(jacc))):
        np.testing.assert_array_equal(v, w)
    acc, model, _ = _port_accelerator(fam, params, stats)
    want = {k: v.clone() for k, v in model.fp8_histories().items()}
    step = acc.build_train_step(loss_fn=lambda m, b: m(**b)["loss"], micro_steps=2)
    step(_torch_batch(batch))
    assert model.fp8_record is True
    for name, hist in model.fp8_histories().items():
        assert torch.equal(hist, want[name]), name
    acc.build_train_step(micro_steps=2)(_torch_batch(batch))
    assert all(not torch.equal(h, want[n]) for n, h in model.fp8_histories().items())
    JaxState._reset_state(reset_partial_state=True)


def test_eager_loop_rolls_once_per_update():
    """The eager loop with two accumulation steps: the first micro-step
    records into slot 0 and does not roll; the update rolls (slot 0 zero,
    slot 1 the two micro-steps' max), as the JAX Accelerator's eager loop
    (histories 1e-5 relative)."""
    fam = FAMILIES["decoder"]
    _, params, stats = _init(fam, "delayed")
    jacc, jmodel = _jax_accelerator(fam, params, stats, gradient_accumulation_steps=2)
    jopt = jacc._optimizers[0]
    acc, model, opt = _port_accelerator(fam, params, stats, gradient_accumulation_steps=2)
    first = model.fp8_histories()["layers.0.attn.wq_fp8"].clone()
    for i in range(2):
        batch = fam.batch(i)
        with jacc.accumulate(jmodel):
            jacc.backward(jmodel(**batch)["loss"])
            jopt.step()
            jopt.zero_grad()
        with acc.accumulate(model):
            acc.backward(model(**_torch_batch(batch))["loss"])
            opt.step()
            opt.zero_grad()
        hist = model.fp8_histories()["layers.0.attn.wq_fp8"]
        if i == 0:  # recorded, not rolled
            assert torch.equal(hist[:, 1:], first[:, 1:]) and (hist[:, 0] >= first[:, 0]).all()
            assert hist[0, 0] > first[0, 0]
    assert not hist[:, 0].any() and torch.equal(hist[:, 2:], first[:, 1:-1])
    for (path, w), (_, g) in zip(_leaves(_jax_histories(jacc)), _leaves(_histories(model))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=jax.tree_util.keystr(path))
    JaxState._reset_state(reset_partial_state=True)


def test_accelerator_fp8_turns_use_fp8_on():
    """mixed_precision="fp8": bf16 compute over fp32 masters, and prepare
    turns on use_fp8 on a copy of the config that every module shares; a
    model built without the delayed recipe's histories then runs current
    scaling, with one warning, as the reference's."""
    acc = Accelerator(mixed_precision="fp8", device="cpu")
    assert acc.state.precision.compute_dtype == torch.bfloat16
    assert acc.state.precision.param_dtype == torch.float32
    cfg = DecoderConfig.tiny(fp8_recipe="delayed")
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(_init(FAMILIES["decoder"], "current")[1], FAMILIES["decoder"].port_config(),
                       dtype=torch.float32) if False else
        __import__("accelerate_tpu_torch.models.convert", fromlist=["x"]).random_params(
            cfg, device="cpu", dtype=torch.float32))
    model = acc.prepare(model)
    assert model.config.use_fp8 and not cfg.use_fp8
    assert all(m.config is model.config for m in model.modules() if hasattr(m, "config"))
    assert model.fp8_histories() == {} and acc.extra_state == {}
    fp8._delayed_fallback_warned = False
    ids = torch.from_numpy(_decoder_batch(0)["input_ids"])
    with pytest.warns(UserWarning, match="CURRENT scaling"):
        model(ids, labels=ids)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model(ids, labels=ids)  # once
    for other in ("bf16", "no"):
        m = DecoderLM(DecoderConfig.tiny(), device="cpu", param_dtype=torch.float32)
        Accelerator(mixed_precision=other, device="cpu").prepare(m)
        assert not m.config.use_fp8


def test_capability_warning(monkeypatch):
    """Once on the CPU (no fp8 tensor cores); never on a card of compute
    capability (9, 0)."""
    import warnings

    from accelerate_tpu_torch import accelerator as port_acc

    monkeypatch.setattr(port_acc, "_fp8_tensor_cores_warned", False)
    with pytest.warns(UserWarning, match="no fp8 tensor cores") as record:
        Accelerator(mixed_precision="fp8", device="cpu")
        Accelerator(mixed_precision="fp8", device="cpu")
    assert len([w for w in record if "fp8 tensor cores" in str(w.message)]) == 1
    monkeypatch.setattr(port_acc, "_fp8_tensor_cores_warned", False)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_acc._warn_fp8_without_tensor_cores_once(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "older card")
    with pytest.warns(UserWarning, match="'older card'"):
        port_acc._warn_fp8_without_tensor_cores_once(torch.device("cuda"))


# -- checkpoints ------------------------------------------------------------------


def test_checkpoints_cross_load_and_resume(tmp_path, monkeypatch):
    """A delayed model's checkpoint carries its histories as the
    reference's ``extra_state/fp8_stats/...``: each side saves after one
    update, the other (built over other weights and histories) loads it,
    holds the saver's histories bit for bit and takes the next update as
    the saver does (loss 1e-5 relative, histories 1e-5 relative)."""
    monkeypatch.setattr("accelerate_tpu.checkpointing._is_sharded_tree", lambda tree: False)
    fam = FAMILIES["decoder"]
    _, params, stats = _init(fam, "delayed")
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    b1, b2 = _two_batches(fam, 1), _two_batches(fam, 2)

    jacc, _ = _jax_accelerator(fam, params, stats)
    jstep = jacc.build_train_step(micro_steps=2)
    jstep(b1)
    jacc.save_state(str(tmp_path / "ref"))
    saved = _jax_histories(jacc)
    want_loss = float(jstep(b2)["loss"])
    want_hist = _jax_histories(jacc)
    acc, model, _ = _port_accelerator(fam, params, zero)
    acc.load_state(str(tmp_path / "ref"))
    for (_, w), (_, g) in zip(_leaves(saved), _leaves(_histories(model))):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(acc.build_train_step(micro_steps=2)(_torch_batch(b2))["loss"].item(),
                               want_loss, rtol=1e-5)
    for (_, w), (_, g) in zip(_leaves(want_hist), _leaves(_histories(model))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)

    acc, model, _ = _port_accelerator(fam, params, stats)
    step = acc.build_train_step(micro_steps=2)
    step(_torch_batch(b1))
    acc.save_state(str(tmp_path / "port"))
    saved = _histories(model)
    want_loss = step(_torch_batch(b2))["loss"].item()
    jacc, _ = _jax_accelerator(fam, params, zero)
    jacc.load_state(str(tmp_path / "port"))
    for (_, w), (_, g) in zip(_leaves(saved), _leaves(_jax_histories(jacc))):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(float(jacc.build_train_step(micro_steps=2)(b2)["loss"]),
                               want_loss, rtol=1e-5)
    JaxState._reset_state(reset_partial_state=True)


def test_missing_histories_are_kept_with_one_warning(tmp_path):
    """A checkpoint without the histories (saved by a model built without
    the delayed recipe) loads into a delayed model: the weights load, the
    histories keep their values, one warning says how many."""
    fam = FAMILIES["decoder"]
    _, params, stats = _init(fam, "delayed")
    cfg = fam.port_config(use_fp8=True)
    plain = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(params, cfg, dtype=torch.float32))
    acc = Accelerator(device="cpu")
    acc.prepare(plain, torch.optim.AdamW(plain.parameters(), lr=LR))
    acc.save_state(str(tmp_path / "ckpt"))
    acc, model, _ = _port_accelerator(fam, params, stats)
    kept = {k: v.clone() for k, v in model.fp8_histories().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    with pytest.warns(UserWarning, match=r"^14 state entries absent.*fp8_stats/layers/block"):
        acc.load_state(str(tmp_path / "ckpt"))
    assert all(torch.equal(v, kept[k]) for k, v in model.fp8_histories().items())
    for (n, p), q in zip(model.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), n


# -- telemetry ---------------------------------------------------------------------


def test_fp8_amax_health_matches_reference(tmp_path):
    """The reference's cases (tests/test_telemetry.py) and numpy-seeded
    stacked trees give the reference's keys and values; an Accelerator's
    telemetry rollup reports a delayed model's health."""
    from accelerate_tpu.telemetry.metrics import fp8_amax_health as ref_health
    from accelerate_tpu_torch.telemetry import TelemetryConfig
    from accelerate_tpu_torch.telemetry.metrics import fp8_amax_health

    healthy = {"dot": np.asarray([[0.0, 3.5, 1.0], [0.0, 2.0, 1.0]], np.float32)}
    rs = np.random.RandomState(2)
    stacked = {"layers": {"a": np.abs(rs.standard_normal((3, 2, 4))).astype(np.float32),
                          "b": np.zeros((3, 2, 4), np.float32)}}
    for tree in (healthy, {"dot": np.zeros((2, 3), np.float32)}, {}, stacked,
                 {"one": np.ones((2, 1), np.float32)}):
        want = ref_health(jax.tree_util.tree_map(jnp.asarray, tree))
        assert fp8_amax_health(jax.tree_util.tree_map(torch.from_numpy, tree)) == want
        assert fp8_amax_health(tree) == want
    fam = FAMILIES["decoder"]
    _, params, stats = _init(fam, "delayed")
    acc, model, _ = _port_accelerator(fam, params, stats, telemetry=TelemetryConfig(
        trace_dir=str(tmp_path), flight_hooks=False, timeline_interval_s=0))
    acc.build_train_step(micro_steps=2)(_torch_batch(_two_batches(fam, 0)))
    out = acc.telemetry.rollup()
    assert out["sys/fp8_amax_stale_frac"] == 0.0
    assert out["sys/fp8_amax_max"] == fp8_amax_health(model.fp8_histories())["sys/fp8_amax_max"]
    acc.end_training()
