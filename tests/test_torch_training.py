"""The port's training step against the JAX package's, on the CPU.

- ``DecoderLM``'s loss and every gradient leaf, at ``tiny`` with GQA 4 -> 2
  and seq 256, with ``attention_impl="flash"`` on both sides (the JAX
  model runs its Pallas kernels in interpret mode, the port the kernels'
  plain versions), weights carried by ``from_reference`` and gradients
  brought back by ``to_reference``;
- the losses (``softmax_cross_entropy``, ``fused_linear_cross_entropy``)
  and ``warmup_cosine_decay_schedule`` against their JAX / optax
  counterparts;
- the ``Accelerator``'s accumulation window, its loader's end, bf16
  rounding at use and its refusal of low-precision masters;
- the remat policies (off, "full", "save_attention") give the same
  gradients, and "save_attention" runs the flash forward once per layer.

AdamW steps against the JAX ``Accelerator`` are in
tests/test_torch_training_accelerator.py (the eager loop and
``build_train_step``) and tests/test_torch_training_window.py
(``steps_per_call=2``), split from this file so that pytest's
``--dist loadfile`` spreads them over workers; they share this file's
helpers.

Inputs are numpy arrays from a seed; both sides run in fp32. Tolerances
are stated where they are used.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.ops import losses as ref_losses
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu_torch import Accelerator, warmup_cosine_decay_schedule
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.ops import kernels, losses

SEQ = 256


def _cfg(**kw):
    kw.setdefault("attention_impl", "flash")
    return DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, **kw)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_close(got, want, rel, what):
    """Every leaf within ``rel`` times that leaf's largest |entry|."""
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g, w, atol=rel * np.abs(w).max(), rtol=0,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def reference():
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash")
    params, _ = unbox_params(
        JaxLM(jcfg).init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=SEQ)["params"])
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, **kw):
    cfg = _cfg(**kw)
    return DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(params, cfg, dtype=torch.float32))


def _batch(seed, b):
    ids = np.random.RandomState(seed).randint(0, 256, (b, SEQ)).astype(np.int32)
    labels = ids.copy()
    labels[1, :17] = -100  # ignored targets
    return ids, labels


def test_loss_and_grads_match_reference(reference):
    """Tolerance: loss 1e-5 relative, each gradient leaf 1e-4 of its largest
    entry (fp32 through two layers and a 256-way softmax summed in another
    order by XLA and PyTorch; observed ~2e-6)."""
    jcfg, params = reference
    ids, labels = _batch(0, 2)

    def jloss(p):
        return JaxLM(jcfg).apply({"params": p}, jnp.asarray(ids),
                                 labels=jnp.asarray(labels))["loss"]

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = _port_model(params)
    out = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert set(out) == {"loss"}
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(want_loss), rtol=1e-5)
    grads = to_reference({n: p.grad for n, p in model.named_parameters()}, model.config)
    _assert_trees_close(grads, want_grads, 1e-4, "grad")


def test_to_reference_round_trips(reference):
    _, params = reference
    model = _port_model(params)
    back = to_reference(dict(model.state_dict()), model.config)
    _assert_trees_close(back, params, 0.0, "weight")


@pytest.mark.parametrize("remat,policy,forwards", [
    (False, "save_attention", 1), (True, "save_attention", 1), (True, "full", 2)],
    ids=["off", "save_attention", "full"])
def test_remat_policies_give_the_same_grads(reference, monkeypatch, remat, policy, forwards):
    """Recomputation runs the same ops in the same order; only the
    embedding's backward (a scatter-add summing repeated tokens in a
    thread-dependent order) may differ in the last bits, hence 1e-5
    relative. "save_attention" keeps the flash op's residuals, so the
    forward kernel runs once per layer; "full" re-runs it in backward."""
    _, params = reference
    ids, labels = _batch(1, 2)
    base = _port_model(params, remat=False)
    base(torch.from_numpy(ids), labels=torch.from_numpy(labels))["loss"].backward()

    calls = []
    real = kernels.flash_fwd
    monkeypatch.setattr(kernels, "flash_fwd", lambda *a: calls.append(1) or real(*a))
    model = _port_model(params, remat=remat, remat_policy=policy)
    model(torch.from_numpy(ids), labels=torch.from_numpy(labels))["loss"].backward()
    assert len(calls) == forwards * model.config.num_layers
    for (n, p), q in zip(model.named_parameters(), base.parameters()):
        torch.testing.assert_close(p.grad, q.grad, atol=1e-8, rtol=1e-5, msg=n)


# -- losses -------------------------------------------------------------------


@pytest.mark.parametrize("ignore_index,smoothing", [(None, 0.0), (-100, 0.0), (-100, 0.1)])
def test_softmax_cross_entropy_matches_reference(ignore_index, smoothing):
    """Tolerance 1e-6 relative: fp32 logsumexp on both sides."""
    rng = np.random.RandomState(2)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    if ignore_index is not None:
        labels[0, :4] = ignore_index
    want = ref_losses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            ignore_index=ignore_index,
                                            label_smoothing=smoothing)
    got = losses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       ignore_index=ignore_index, label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("n,chunks,ignore", [(32, 8, -100), (30, 8, -100), (30, 4, None)],
                         ids=["strided-8", "fallback-6", "fallback-3-no-ignore"])
def test_fused_linear_cross_entropy_matches_reference(n, chunks, ignore):
    """Loss and the gradients of hidden and the vocab kernel; a token
    count that chunks does not divide falls back to fewer chunks.
    Tolerance 1e-5 relative (fp32 matmuls summed in another order)."""
    rng = np.random.RandomState(3)
    hidden = rng.standard_normal((n, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 40)).astype(np.float32) * 0.5
    labels = rng.randint(0, 40, (n,)).astype(np.int32)
    labels[::5] = -100 if ignore is not None else labels[::5]

    def jloss(h, w):
        return ref_losses.fused_linear_cross_entropy(h, w, jnp.asarray(labels),
                                                     ignore_index=ignore, num_chunks=chunks)

    want, (gh, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hidden),
                                                              jnp.asarray(kernel))
    th, tw = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(kernel).requires_grad_()
    got = losses.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels),
                                            ignore_index=ignore, num_chunks=chunks)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-7)


def test_fused_cross_entropy_equals_plain_cross_entropy():
    rng = np.random.RandomState(4)
    hidden = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    kernel = torch.from_numpy(rng.standard_normal((8, 30)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 30, (24,)))
    labels[:5] = -100
    fused = losses.fused_linear_cross_entropy(hidden, kernel, labels, ignore_index=-100)
    plain = losses.softmax_cross_entropy(hidden @ kernel, labels, ignore_index=-100)
    torch.testing.assert_close(fused, plain, rtol=1e-6, atol=0.0)


# -- schedule -----------------------------------------------------------------


@pytest.mark.parametrize("init,peak,warmup,decay,end,exponent", [
    (0.0, 3e-4, 100, 1000, 0.0, 1.0), (1e-5, 1e-3, 10, 200, 1e-4, 2.0)])
def test_warmup_cosine_decay_matches_optax(init, peak, warmup, decay, end, exponent):
    """peak * f(step) equals optax's value at steps 0..1100, past the end
    of the decay. Tolerance 1e-6 relative plus 1e-6 * peak: optax
    evaluates in fp32, where (init - peak) * frac + peak rounds at the
    scale of peak (6e-8 of it per operation) even when the value is small."""
    want_fn = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end, exponent)
    f = warmup_cosine_decay_schedule(init, peak, warmup, decay, end, exponent)
    steps = np.arange(0, 1101)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps)))
    got = np.array([peak * f(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)


def test_lambda_lr_applies_the_schedule_before_each_update():
    """optax evaluates the schedule at the count before the update: the
    k-th update (from 0) uses schedule(k)."""
    p = torch.nn.Parameter(torch.zeros(()))
    opt = torch.optim.SGD([p], lr=3e-4)
    f = warmup_cosine_decay_schedule(0.0, 3e-4, 100, 1000)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, f)
    for k in range(5):
        assert opt.param_groups[0]["lr"] == pytest.approx(3e-4 * f(k), rel=1e-12)
        opt.step()
        sched.step()


# -- the Accelerator ----------------------------------------------------------

LR, BETAS, EPS, WD, CLIP = 3e-3, (0.9, 0.999), 1e-8, 1e-4, 0.1
EAGER_MICRO, FUSED_STEPS = 10, 2  # 5 eager updates of 2 micro-batches, then 2 fused


def _data():
    return np.random.RandomState(5).randint(0, 256, (EAGER_MICRO, 8, SEQ)).astype(np.int32)


def test_optimizer_skips_while_accumulating():
    """step() and zero_grad() do nothing until the window closes; the
    scheduler advances only with a real update."""
    acc = Accelerator(gradient_accumulation_steps=3, device="cpu")
    w = torch.nn.Linear(2, 1, bias=False)
    opt = torch.optim.SGD(w.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0 / (k + 1))
    w, opt, sched = acc.prepare(w, opt, sched)
    x = torch.ones((1, 2))
    before = w.weight.detach().clone()
    for i in range(3):
        with acc.accumulate(w):
            acc.backward(w(x).sum())
            opt.step()
            sched.step()
            opt.zero_grad()
        if i < 2:
            torch.testing.assert_close(w.weight.detach(), before)
            assert w.weight.grad is not None and opt.param_groups[0]["lr"] == 0.1
    # one update with the mean of three identical gradients (x = 1)
    torch.testing.assert_close(w.weight.detach(), before - 0.1)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)
    assert not opt.step_was_skipped


def test_dataloader_end_closes_the_window():
    """A prepared loader's last batch syncs even mid-window."""
    acc = Accelerator(gradient_accumulation_steps=4, device="cpu")
    loader = acc.prepare([{"x": np.ones(2, np.float32)} for _ in range(3)])
    syncs = []
    for batch in loader:
        assert isinstance(batch["x"], torch.Tensor)
        with acc.accumulate():
            syncs.append(acc.sync_gradients)
    assert syncs == [False, False, True]


def test_bf16_rounds_every_parameter_at_use(reference):
    """Under mixed_precision="bf16" the fp32 master weights stay fp32 and
    the forward reads them rounded to bf16, norm weights and the embedding
    included: the loss equals that of a model whose fp32 weights were
    rounded to bf16 beforehand."""
    _, params = reference
    ids, labels = _batch(6, 2)
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    model = acc.prepare(_port_model(params, dtype=torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))["loss"]
    rounded = _port_model(params, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    want = rounded(torch.from_numpy(ids), labels=torch.from_numpy(labels))["loss"]
    assert got.item() == pytest.approx(want.item(), rel=1e-6)
    ln = model.layers[0].ln_attn
    with torch.no_grad():
        ln.add_(1e-4)  # below bf16 resolution at 1.0: invisible at use
    again = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))["loss"]
    assert again.item() == pytest.approx(got.item(), rel=1e-6)


def test_prepare_refuses_low_precision_masters():
    acc = Accelerator(mixed_precision="bf16", device="cpu")
    serving_layout = DecoderLM(DecoderConfig.tiny(dtype=torch.bfloat16), device="cpu")
    with pytest.raises(ValueError, match="master"):
        acc.prepare(serving_layout)
