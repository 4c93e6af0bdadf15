"""The port's T5-family ``Seq2SeqLM`` against the JAX package's, on the CPU.

- ``shift_right`` on the reference's cases (``tests/test_seq2seq.py``
  ``TestShiftRight``) and against the JAX function;
- logits and loss (the fused LM-head CE, -100 ignored) with right-padded
  sources, tied and untied heads, weights carried by ``from_reference``;
- gradients of every leaf, and the parameters after one AdamW update of
  the port's ``Accelerator.build_train_step`` against the JAX
  ``Accelerator``'s, every AdamW hyperparameter given on both sides;
- ``convert.py`` both ways bit for bit (reference tree -> port -> tree,
  and the port's ``random_params`` -> tree -> port);
- a reference ``save_state`` resumed in the port and the port's resumed
  in the reference;
- the rules: pipelining raises naming its item, an fp8 config builds and
  runs, no CUDA raises
  without ``device="cpu"``; dropout masks replay under ``set_seed``.

Inputs are numpy arrays from a seed; both sides run in fp32 at
``Seq2SeqConfig.tiny`` widths. Tolerances are stated where they are used.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import Seq2SeqConfig as JaxConfig
from accelerate_tpu.models import Seq2SeqLM as JaxLM
from accelerate_tpu.models.seq2seq import shift_right as jax_shift_right
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator, set_seed
from accelerate_tpu_torch.models import Seq2SeqConfig, Seq2SeqLM, shift_right
from accelerate_tpu_torch.models.convert import from_reference, random_params, to_reference

B, SRC, TGT = 8, 16, 12
# Adam's first update is lr * g / (|g| + eps) per entry, whose slope at
# |g| ~ eps is lr / (4 eps): at eps 1e-8 a gradient entry of 2e-9 whose
# fp32 summation noise is 6e-11 (1.6e-7 of the leaf's largest entry) moves
# its update by 1.4e-5 (observed). eps 1e-6 keeps every entry's update well
# conditioned, so the comparison reads the port and not that slope
LR, BETAS, EPS, WD = 3e-3, (0.9, 0.999), 1e-6, 1e-4


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def reference(request):
    """(JAX model, its params as numpy, the port's config) at tiny widths."""
    kw = dict(tie_embeddings=request.param)
    jm = JaxLM(JaxConfig.tiny(**kw))
    variables = jm.init_variables(jax.random.PRNGKey(0), batch_size=2, seq_len=SRC,
                                  target_len=TGT)
    params = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    return jm, params, Seq2SeqConfig.tiny(**kw)


def _port(params, cfg):
    return Seq2SeqLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(params, cfg, dtype=torch.float32))


def _batch(seed):
    """Sources with two right-padded rows, labels with ignored targets."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 256, (B, SRC)).astype(np.int32)
    mask = np.ones((B, SRC), np.int32)
    mask[1, 10:] = 0
    mask[2, 4:] = 0
    labels = rng.randint(3, 256, (B, TGT)).astype(np.int32)
    labels[0, :3] = -100
    labels[3, -2:] = -100
    return src, mask, labels


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("labels,want", [([[5, 6, 7], [8, 9, 10]], [[0, 5, 6], [0, 8, 9]]),
                                         ([[5, -100, 7]], [[0, 5, 0]])],
                         ids=["prepends_start_and_drops_last", "ignore_markers_become_start"])
def test_shift_right(labels, want):
    got = shift_right(torch.tensor(labels), 0)
    assert got.tolist() == want
    assert got.tolist() == np.asarray(jax_shift_right(jnp.asarray(labels), 0)).tolist()


def test_forward_and_loss_match_reference(reference):
    """Logits 1e-4 absolute + 1e-4 relative, loss 1e-5 relative (fp32 on
    both sides; observed ~7e-7 on the logits). Decoder inputs omitted
    equal ``shift_right(labels)`` given."""
    jm, params, cfg = reference
    src, mask, labels = _batch(0)
    dec_in = np.asarray(jax_shift_right(jnp.asarray(labels), cfg.decoder_start_token_id))
    run = jax.jit(lambda s, m, d, y: (
        jm.apply({"params": params}, s, decoder_input_ids=d, attention_mask=m)["logits"],
        jm.apply({"params": params}, s, labels=y, attention_mask=m)["loss"]))
    want_logits, want_loss = run(src, mask, dec_in, labels)
    model = _port(params, cfg)
    with torch.no_grad():
        logits = model(_t(src), decoder_input_ids=_t(dec_in).long(),
                       attention_mask=_t(mask))["logits"]
        loss = model(_t(src), labels=_t(labels).long(), attention_mask=_t(mask))["loss"]
        explicit = model(_t(src), decoder_input_ids=_t(dec_in).long(), labels=_t(labels).long(),
                         attention_mask=_t(mask))["loss"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert explicit.item() == loss.item()


def test_masked_source_tokens_do_not_move_the_loss(reference):
    _, params, cfg = reference
    src, mask, labels = _batch(1)
    model = _port(params, cfg)
    other = src.copy()
    other[1, 10:] = 7
    other[2, 4:] = 9
    with torch.no_grad():
        a = model(_t(src), labels=_t(labels).long(), attention_mask=_t(mask))["loss"]
        b = model(_t(other), labels=_t(labels).long(), attention_mask=_t(mask))["loss"]
    assert a.item() == pytest.approx(b.item(), rel=1e-6)


def test_grads_and_one_adamw_update_match_reference(reference):
    """The JAX ``Accelerator.build_train_step`` and the port's, one update
    of ``optax.adamw`` / ``torch.optim.AdamW`` with the same hyperparameters
    on a padded batch. Loss 1e-5 relative, grad norm 1e-4 relative, each
    gradient leaf within 1e-4 of its largest entry (fp32 summed in other
    orders), parameters 2e-5 absolute after the update (Adam's first step
    moves each entry by ~lr, so summation noise in a small gradient entry
    becomes update noise: the bound and reason of
    test_torch_training.py::test_accelerator_tracks_reference)."""
    jm, params, cfg = reference
    src, mask, labels = _batch(2)
    batch = {"input_ids": src, "labels": labels, "attention_mask": mask}

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(src), labels=jnp.asarray(labels),
                        attention_mask=jnp.asarray(mask))["loss"]

    _, want_grads = jax.jit(jax.value_and_grad(jloss))(params)

    JaxState._reset_state(reset_partial_state=True)
    jacc = JaxAccelerator()
    jmodel, _ = jacc.prepare(
        Model(JaxLM(jm.config, mesh=jacc.mesh), {"params": params}),
        optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    want = jacc.build_train_step()(batch)
    want_final = jax.tree_util.tree_map(
        np.asarray, unbox_params(jacc.unwrap_model(jmodel).params)[0])
    JaxState._reset_state(reset_partial_state=True)

    model = _port(params, cfg)
    out = model(_t(src), labels=_t(labels).long(), attention_mask=_t(mask))
    out["loss"].backward()
    grads = to_reference({n: p.grad for n, p in model.named_parameters()}, cfg)
    for (path, w), (_, g) in zip(_leaves(want_grads), _leaves(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=f"grad {jax.tree_util.keystr(path)}")

    acc = Accelerator(device="cpu")
    model = _port(params, cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    model, opt = acc.prepare(model, opt)
    got = acc.build_train_step()({k: _t(v).long() if k == "labels" else _t(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    final = to_reference(dict(model.state_dict()), cfg)
    for (path, w), (_, g) in zip(_leaves(want_final), _leaves(final)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                   err_msg=f"param {jax.tree_util.keystr(path)}")


def test_conversion_round_trips_bit_for_bit(reference):
    jm, params, cfg = reference
    back = to_reference(dict(_port(params, cfg).state_dict()), cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for (path, w), (_, g) in zip(_leaves(params), _leaves(back)):
        assert np.array_equal(g, w), jax.tree_util.keystr(path)
    fresh = random_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    again = from_reference(to_reference(fresh, cfg), cfg, dtype=torch.float32)
    assert set(again) == set(fresh)
    assert all(torch.equal(again[k], fresh[k]) for k in fresh)
    model = Seq2SeqLM(cfg, device="cpu", param_dtype=torch.float32).load_params(fresh)
    assert set(dict(model.state_dict())) == set(fresh)


# -- checkpoints ----------------------------------------------------------------


def _jax_engine(params, jcfg):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator()
    model, opt = acc.prepare(Model(JaxLM(jcfg, mesh=acc.mesh), {"params": params}),
                             optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS,
                                         weight_decay=WD))
    return acc, model, acc.build_train_step()


def _port_engine(params, cfg):
    acc = Accelerator(device="cpu")
    model = _port(params, cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    model, opt = acc.prepare(model, opt)
    return acc, model, acc.build_train_step()


def _port_batch(seed):
    src, mask, labels = _batch(seed)
    return {"input_ids": _t(src), "labels": _t(labels).long(), "attention_mask": _t(mask)}


def _jax_batch(seed):
    src, mask, labels = _batch(seed)
    return {"input_ids": src, "labels": labels, "attention_mask": mask}


def test_checkpoints_cross_load_and_resume(reference, tmp_path, monkeypatch):
    """Each side trains one update and saves; the other side, built over
    other weights, loads the checkpoint and takes the next update. Its
    loss (1e-5 relative) and parameters (2e-5 absolute) equal the saving
    side's own next update."""
    jm, params, cfg = reference
    other = to_reference(random_params(cfg, seed=9, device="cpu", dtype=torch.float32), cfg)
    # the harness's 8-device mesh would make the reference write per-rank
    # manifests (a later slice of the port); one device takes its
    # consolidated path
    monkeypatch.setattr("accelerate_tpu.checkpointing._is_sharded_tree", lambda tree: False)

    jacc, jmodel, jstep = _jax_engine(params, jm.config)
    jstep(_jax_batch(3))
    jacc.save_state(str(tmp_path / "ref"))
    want_loss = float(jstep(_jax_batch(4))["loss"])
    want = jax.tree_util.tree_map(np.asarray, unbox_params(jacc.unwrap_model(jmodel).params)[0])
    acc, model, step = _port_engine(other, cfg)
    acc.load_state(str(tmp_path / "ref"))
    got_loss = step(_port_batch(4))["loss"].item()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    got = to_reference(dict(model.state_dict()), cfg)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=jax.tree_util.keystr(path))

    acc, model, step = _port_engine(params, cfg)
    step(_port_batch(3))
    acc.save_state(str(tmp_path / "port"))
    want_loss = step(_port_batch(4))["loss"].item()
    want = to_reference(dict(model.state_dict()), cfg)
    jacc, jmodel, jstep = _jax_engine(other, jm.config)
    jacc.load_state(str(tmp_path / "port"))
    np.testing.assert_allclose(float(jstep(_jax_batch(4))["loss"]), want_loss, rtol=1e-5)
    got = jax.tree_util.tree_map(np.asarray, unbox_params(jacc.unwrap_model(jmodel).params)[0])
    JaxState._reset_state(reset_partial_state=True)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=jax.tree_util.keystr(path))


# -- rules ------------------------------------------------------------------------


# the id this case had beside the fp8 case (now test_fp8_config_builds_and_runs).
# Pipelining the decoder tower is this port's now (tests/test_torch_pipeline_models.py):
# what still raises is a tensor axis on the mesh
@pytest.mark.parametrize("field,item", [({"mesh": {"tensor": 2, "data": 4}}, "item 10")],
                         ids=["field1-item 10"])
def test_unported_fields_raise_naming_their_item(field, item):
    assert Seq2SeqConfig.tiny(num_decoder_layers=4, pipeline_stages=2).pipeline_stages == 2
    with pytest.raises(NotImplementedError, match=item):
        Seq2SeqLM(Seq2SeqConfig.tiny(), device="cpu", **field)


def test_fp8_config_builds_and_runs():
    """fp8 is this port's now (tests/test_torch_fp8_models.py): an fp8 T5
    builds, holds its delayed histories and runs."""
    cfg = Seq2SeqConfig.tiny(use_fp8=True, fp8_recipe="delayed")
    model = Seq2SeqLM(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    assert len(model.fp8_histories()) == 7 * cfg.num_layers + 11 * cfg.num_decoder_layers
    src = torch.arange(3, 11)[None]
    with torch.no_grad():
        assert torch.isfinite(model(src, labels=src)["loss"])


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Seq2SeqLM(Seq2SeqConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_params(Seq2SeqConfig.tiny())
    # an unpipelined model has no manual value-and-grad (the reference's None)
    assert Seq2SeqLM(Seq2SeqConfig.tiny(), device="cpu").pipeline_value_and_grad() is None


def test_t5_base_shape():
    cfg = Seq2SeqConfig()
    assert (cfg.vocab_size, cfg.num_layers, cfg.num_decoder_layers, cfg.embed_dim,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim, cfg.max_seq_len,
            cfg.max_target_len, cfg.max_cache_len, cfg.dtype, cfg.tie_embeddings) == (
        32128, 12, 12, 768, 12, 12, 64, 2048, 1024, 1024, 1024, torch.bfloat16, True)
    assert cfg.num_params == JaxConfig().num_params


def test_dropout_replays_under_set_seed(reference):
    """Masks come from the keychain's "dropout" stream: the same seed
    gives the same loss, another seed another; eval mode drops nothing
    (the loss of a dropout-free model)."""
    _, params, cfg = reference
    src, mask, labels = _batch(5)
    model = _port(params, Seq2SeqConfig.tiny(tie_embeddings=cfg.tie_embeddings,
                                             dropout_rate=0.2))

    def loss(seed=None):
        if seed is not None:
            set_seed(seed)
        with torch.no_grad():
            return model(_t(src), labels=_t(labels).long(), attention_mask=_t(mask))["loss"].item()

    a, b, c = loss(1), loss(1), loss(2)
    assert a == b and a != c
    model.eval()
    with torch.no_grad():
        plain = _port(params, cfg)(_t(src), labels=_t(labels).long(),
                                   attention_mask=_t(mask))["loss"].item()
    assert loss() == plain
