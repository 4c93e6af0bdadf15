"""The remat policies and residual dropout of the port's decoder, on the
CPU.

- ``full``, ``save_attention`` and ``save_dots`` give the gradients of no
  remat, with dropout on, as the reference's three policies do
  (tests/test_models.py); the flash forward runs once per layer under no
  remat and ``save_attention``, twice under ``full`` and ``save_dots``.
- What each policy keeps: ``save_attention`` keeps the flash operator's
  out and lse (``FlashResiduals``) and no q, k or v (a
  ``saved_tensors_hooks`` count sees none leave the block, where no remat
  keeps them), ``save_dots`` every projection matmul's output (seven a
  layer, its selective-checkpoint policy's record).
- Dropout cannot reproduce JAX's bits; it is held by distribution and
  determinism: rate 0 and ``eval()`` equal the reference's model; the
  keep share is within 5 sigma of 0.9 and a kept entry is exactly its
  input over 0.9; masks differ across layers, sites and updates; one seed
  gives one loss bit for bit; a resumed fp16 run with dropout is
  bit-exact.

``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ 128, fp32 activations,
inputs from numpy seeds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from collections import Counter

from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import decoder as dec
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params
from accelerate_tpu_torch.models.decoder import DecoderLM, dropout
from accelerate_tpu_torch.ops import kernels
from accelerate_tpu_torch.ops.attention import FlashResiduals
from accelerate_tpu_torch.utils.random import rng_state_dict, set_seed

SEQ, B, RATE = 128, 2, 0.1


def _model(remat=False, policy="full", rate=RATE, seed=0, **kw):
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash",
                             remat=remat, remat_policy=policy, dropout_rate=rate, **kw)
    return DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        random_params(cfg, seed=seed, device="cpu", dtype=torch.float32))


def _ids(seed=0, b=B):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (b, SEQ)))


def _loss_and_grads(model, ids, seed=0):
    set_seed(seed)
    loss = model(ids, labels=ids)["loss"]
    loss.backward()
    return loss.item(), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("policy,forwards", [("full", 2), ("save_attention", 1),
                                             ("save_dots", 2)])
def test_remat_policies_give_no_remat_grads_with_dropout(monkeypatch, policy, forwards):
    """The recompute repeats every op and every dropout mask: the loss
    and each gradient equal no remat's (observed bit for bit; 1e-6
    relative allowed for the embedding's scatter-add order)."""
    ids = _ids(1)
    want_loss, want = _loss_and_grads(_model(), ids)
    calls = []
    real = kernels.flash_fwd
    monkeypatch.setattr(kernels, "flash_fwd", lambda *a: calls.append(1) or real(*a))
    model = _model(remat=True, policy=policy)
    loss, got = _loss_and_grads(model, ids)
    assert len(calls) == forwards * model.config.num_layers
    assert loss == want_loss
    for (n, _), g, w in zip(model.named_parameters(), got, want):
        torch.testing.assert_close(g, w, atol=1e-9, rtol=1e-6, msg=n)


def _saved(model, ids, monkeypatch):
    """(shapes of the tensors the outer autograd graph keeps, what the
    blocks keep for their recompute: the operators save_dots' policy
    keeps outputs of, and the shapes save_attention's FlashResiduals
    hold)."""
    packed, kept, residuals = Counter(), Counter(), []
    real_policy, real_init = dec._save_dots, FlashResiduals.__init__

    def recording(ctx, op, *args, **kwargs):
        out = real_policy(ctx, op, *args, **kwargs)
        if out == dec.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept[str(op)] += 1
        return out

    def init(self):
        real_init(self)
        residuals.append(self)

    monkeypatch.setattr(dec, "_save_dots", recording)
    monkeypatch.setattr(FlashResiduals, "__init__", init)

    def pack(t):
        packed[tuple(t.shape)] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(ids, labels=ids)["loss"]
    held = [tuple(tuple(t.shape) for t in pair) for r in residuals for pair in r.saved]
    loss.backward()
    return packed, kept, held


def test_what_each_policy_keeps(monkeypatch):
    ids = _ids(2)
    cfg = _model().config
    q_shape = (B, cfg.num_heads, SEQ, cfg.head_dim)
    kv_shape = (B, cfg.num_kv_heads, SEQ, cfg.head_dim)
    layers = cfg.num_layers
    packed, kept, held = _saved(_model(), ids, monkeypatch)  # no remat: the control
    assert packed[q_shape] >= layers and packed[kv_shape] >= 2 * layers
    assert not kept and not held
    packed, kept, held = _saved(_model(remat=True, policy="save_attention"), ids, monkeypatch)
    assert packed[q_shape] == packed[kv_shape] == 0 and not kept
    assert held == [(q_shape, q_shape[:3])] * layers  # out and lse, a layer
    packed, kept, held = _saved(_model(remat=True, policy="save_dots"), ids, monkeypatch)
    assert packed[q_shape] == packed[kv_shape] == 0 and not held
    assert dict(kept) == {"aten.mm.default": 7 * layers}  # q, k, v, o, gate, up, down
    packed, kept, held = _saved(_model(remat=True, policy="full"), ids, monkeypatch)
    assert packed[q_shape] == packed[kv_shape] == 0 and not kept and not held


# -- dropout ------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The reference model's weights, and its loss on a batch with
    dropout_rate 0.1 in deterministic mode (its default apply)."""
    jcfg = JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash",
                          dropout_rate=RATE)
    params, _ = unbox_params(
        JaxLM(jcfg).init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=SEQ)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    ids = _ids(3).numpy().astype(np.int32)
    loss = JaxLM(jcfg).apply({"params": params}, jnp.asarray(ids), labels=jnp.asarray(ids))
    return params, ids, float(loss["loss"])


@pytest.mark.parametrize("rate,mode", [(0.0, "train"), (RATE, "eval")])
def test_rate_zero_and_eval_equal_the_reference(reference, rate, mode):
    """Tolerance 1e-5 relative (fp32 through two layers, XLA and PyTorch
    summing in other orders: test_torch_training.py's bound)."""
    params, ids, want = reference
    cfg = DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash",
                             dropout_rate=rate)
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(params, cfg, dtype=torch.float32))
    model.train(mode == "train")
    t = torch.from_numpy(ids)
    got = model(t, labels=t)["loss"].item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    before = rng_state_dict()["keychain"]["counters"].get("dropout", 0)
    model(t, labels=t)
    assert rng_state_dict()["keychain"]["counters"].get("dropout", 0) == before


def test_dropout_keep_share_and_scale():
    """Over 2^20 entries the keep share is within 5 sigma of 0.9, a kept
    entry is exactly its input over 0.9 (the reference's inputs /
    keep_prob), a dropped one exactly 0."""
    y = torch.randn(16, 256, 256, generator=torch.Generator().manual_seed(0)) + 3.0
    out = dropout(y, RATE, (0, 0, 0), 0)
    kept = out != 0
    n = y.numel()
    share = kept.float().mean().item()
    sigma = (RATE * (1 - RATE) / n) ** 0.5
    assert abs(share - (1 - RATE)) < 5 * sigma
    assert torch.equal(out[kept], y[kept] / (1 - RATE))
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    assert dropout(y, RATE, (0, 0, 0), 0).equal(out)  # one key, one mask


def test_masks_differ_across_layers_sites_updates_and_seeds():
    y = torch.ones(4, 64, 64)
    masks = {key: dropout(y, RATE, key[:3], key[3]) != 0
             for key in ((0, 0, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1), (0, 1, 0, 0), (1, 0, 0, 0))}
    keys = list(masks)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(masks[a], masks[b]), (a, b)


def test_training_forwards_advance_the_dropout_stream():
    """One key per training forward: two forwards after one seed draw
    other masks (other losses), and the same seed replays them bit for
    bit."""
    model = _model()
    ids = _ids(4)
    set_seed(5)
    first = [model(ids, labels=ids)["loss"].item() for _ in range(2)]
    set_seed(5)
    again = [model(ids, labels=ids)["loss"].item() for _ in range(2)]
    assert first == again and first[0] != first[1]
    assert rng_state_dict()["keychain"] == {"seed": 5, "counters": {"dropout": 2}}


def _fp16_run(model, acc_kw, batches, save_after=None, load_from=None):
    acc = Accelerator(mixed_precision="fp16", device="cpu", **acc_kw)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3)
    model, opt = acc.prepare(model, opt)
    if load_from is not None:
        acc.load_state(load_from)
    losses = []
    for i, ids in enumerate(batches):
        with acc.accumulate(model):
            loss = model(ids, labels=ids)["loss"]
            acc.backward(loss)
            opt.step()
            opt.zero_grad()
        losses.append(loss.item())
        if save_after is not None and i + 1 == save_after[0]:
            acc.save_state(save_after[1])
    return losses, acc, model


def test_fp16_resume_with_dropout_is_bit_exact(tmp_path):
    """fp16 with dropout 0.1: a run saved after 2 updates and resumed in
    a fresh process-like state (other weights, other seed) gives the
    uninterrupted run's losses, loss scale and parameters bit for bit:
    the checkpoint carries the dropout stream's position (the keychain)
    and the scale. Without the stream's position the resume differs."""
    batches = [_ids(10 + i) for i in range(4)]
    set_seed(0)
    want, acc_a, model_a = _fp16_run(_model(), {}, batches, save_after=(2, str(tmp_path)))
    set_seed(123)
    got, acc_b, model_b = _fp16_run(_model(seed=9), {}, batches[2:], load_from=str(tmp_path))
    assert got == want[2:]
    assert acc_b.loss_scale.state_dict() == acc_a.loss_scale.state_dict()
    for p, q in zip(model_b.parameters(), model_a.parameters()):
        assert torch.equal(p, q)
    # control: the same resume with the stream's position dropped
    import pickle

    path = tmp_path / "random_states_0.pkl"
    state = pickle.load(open(path, "rb"))
    state["keychain"]["counters"] = {}
    pickle.dump(state, open(path, "wb"))
    set_seed(123)
    other, _, _ = _fp16_run(_model(seed=9), {}, batches[2:], load_from=str(tmp_path))
    assert other != want[2:]
