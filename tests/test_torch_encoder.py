"""The port's BERT-family ``EncoderClassifier`` against the JAX package's,
on the CPU.

- logits and loss with right-padded ``attention_mask`` rows and
  ``token_type_ids`` (the tanh GELU, the fp32 LayerNorms, the pooler),
  weights carried by ``from_reference``; whole-block remat gives the same
  gradients;
- gradients of every leaf, and the parameters after one AdamW update of
  the port's ``Accelerator.build_train_step`` against the JAX
  ``Accelerator``'s, every AdamW hyperparameter given on both sides;
- ``convert.py`` both ways bit for bit (unrolled ``layer_{i}`` names);
- a reference ``save_state`` resumed in the port and the port's resumed
  in the reference;
- the rules: a mesh raises, no CUDA raises without ``device="cpu"``, an fp8
  config builds and runs;
  dropout masks replay under ``set_seed``.

Inputs are numpy arrays from a seed; both sides run in fp32 at
``EncoderConfig.tiny`` widths with dropout off (its masks are the
keychain's, not JAX's bits). Tolerances are stated where they are used.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import EncoderClassifier as JaxClassifier
from accelerate_tpu.models import EncoderConfig as JaxConfig
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator, set_seed
from accelerate_tpu_torch.models import EncoderClassifier, EncoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params, to_reference

B, S = 8, 16
# eps 1e-6: test_torch_seq2seq.py says why (Adam's first update at |g| ~ eps)
LR, BETAS, EPS, WD = 3e-3, (0.9, 0.999), 1e-6, 1e-4


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def reference():
    """(JAX model, its params as numpy, the port's config), dropout off."""
    jm = JaxClassifier(JaxConfig.tiny(dropout_rate=0.0))
    variables = jm.init_variables(jax.random.PRNGKey(0), batch_size=2, seq_len=S)
    params = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    return jm, params, EncoderConfig.tiny(dropout_rate=0.0)


def _port(params, cfg):
    return EncoderClassifier(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(params, cfg, dtype=torch.float32))


def _batch(seed):
    """Rows 1 and 2 right-padded to 10 and 4, two segments of token types."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 256, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 10:] = 0
    mask[2, 4:] = 0
    types = (np.arange(S)[None, :] >= rng.randint(2, S, (B, 1))).astype(np.int32)
    labels = rng.randint(0, 2, (B,)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": types, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)).long() if k == "labels"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_forward_and_loss_match_reference(reference):
    """Logits 1e-4 absolute + 1e-4 relative, loss 1e-5 relative (fp32;
    observed ~2e-7 on the logits)."""
    jm, params, cfg = reference
    batch = _batch(0)
    want = jax.jit(lambda b: jm.apply({"params": params}, **b))(batch)
    with torch.no_grad():
        got = _port(params, cfg)(**_t(batch))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    plain = dict(_t(batch))
    del plain["token_type_ids"], plain["labels"]
    with torch.no_grad():
        zero_types = _port(params, cfg)(**plain)
    want0 = jm.apply({"params": params}, jnp.asarray(batch["input_ids"]),
                     jnp.asarray(batch["attention_mask"]))
    np.testing.assert_allclose(zero_types["logits"].numpy(), np.asarray(want0["logits"]),
                               atol=1e-4, rtol=1e-4)
    assert set(zero_types) == {"logits"}


def test_grads_and_one_adamw_update_match_reference(reference):
    """Tolerances of test_torch_seq2seq.py's: loss 1e-5 relative, grad
    norm 1e-4 relative, each gradient leaf within 1e-4 of its largest
    entry, parameters 2e-5 absolute after the update. Whole-block remat
    gives the no-remat gradients (1e-6 relative: the same ops again)."""
    jm, params, cfg = reference
    batch = _batch(1)

    def jloss(p):
        return jm.apply({"params": p}, **{k: jnp.asarray(v) for k, v in batch.items()})["loss"]

    _, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    JaxState._reset_state(reset_partial_state=True)
    jacc = JaxAccelerator()
    jmodel, _ = jacc.prepare(
        Model(JaxClassifier(jm.config, mesh=jacc.mesh), {"params": params}),
        optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    want = jacc.build_train_step()(batch)
    want_final = jax.tree_util.tree_map(
        np.asarray, unbox_params(jacc.unwrap_model(jmodel).params)[0])
    JaxState._reset_state(reset_partial_state=True)

    grads = {}
    for remat in (False, True):
        model = _port(params, EncoderConfig.tiny(dropout_rate=0.0, remat=remat))
        model(**_t(batch))["loss"].backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, atol=1e-8, rtol=1e-6, msg=n)
    for (path, w), (_, g) in zip(_leaves(want_grads), _leaves(to_reference(grads[False], cfg))):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=f"grad {jax.tree_util.keystr(path)}")

    acc = Accelerator(device="cpu")
    model = _port(params, cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    model, opt = acc.prepare(model, opt)
    got = acc.build_train_step()(_t(batch))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    for (path, w), (_, g) in zip(_leaves(want_final),
                                 _leaves(to_reference(dict(model.state_dict()), cfg))):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                   err_msg=f"param {jax.tree_util.keystr(path)}")


def test_conversion_round_trips_bit_for_bit(reference):
    _, params, cfg = reference
    back = to_reference(dict(_port(params, cfg).state_dict()), cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for (path, w), (_, g) in zip(_leaves(params), _leaves(back)):
        assert np.array_equal(g, w), jax.tree_util.keystr(path)
    assert "layer_1" in back and "layers" not in back
    fresh = random_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    again = from_reference(to_reference(fresh, cfg), cfg, dtype=torch.float32)
    assert set(again) == set(fresh) == set(dict(_port(params, cfg).state_dict()))
    assert all(torch.equal(again[k], fresh[k]) for k in fresh)


def _jax_engine(params, jcfg):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator()
    model, _ = acc.prepare(Model(JaxClassifier(jcfg, mesh=acc.mesh), {"params": params}),
                           optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS,
                                       weight_decay=WD))
    return acc, model, acc.build_train_step()


def _port_engine(params, cfg):
    acc = Accelerator(device="cpu")
    model = _port(params, cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    model, _ = acc.prepare(model, opt)
    return acc, model, acc.build_train_step()


def test_checkpoints_cross_load_and_resume(reference, tmp_path, monkeypatch):
    """Each side trains one update and saves; the other side, built over
    other weights, loads the checkpoint and takes the next update: loss
    1e-5 relative and parameters 2e-5 absolute against the saving side's
    own next update."""
    jm, params, cfg = reference
    other = to_reference(random_params(cfg, seed=9, device="cpu", dtype=torch.float32), cfg)
    # one device: the reference's consolidated save (see test_torch_checkpointing.py)
    monkeypatch.setattr("accelerate_tpu.checkpointing._is_sharded_tree", lambda tree: False)

    jacc, jmodel, jstep = _jax_engine(params, jm.config)
    jstep(_batch(3))
    jacc.save_state(str(tmp_path / "ref"))
    want_loss = float(jstep(_batch(4))["loss"])
    want = jax.tree_util.tree_map(np.asarray, unbox_params(jacc.unwrap_model(jmodel).params)[0])
    acc, model, step = _port_engine(other, cfg)
    acc.load_state(str(tmp_path / "ref"))
    np.testing.assert_allclose(step(_t(_batch(4)))["loss"].item(), want_loss, rtol=1e-5)
    for (path, w), (_, g) in zip(_leaves(want),
                                 _leaves(to_reference(dict(model.state_dict()), cfg))):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=jax.tree_util.keystr(path))

    acc, model, step = _port_engine(params, cfg)
    step(_t(_batch(3)))
    acc.save_state(str(tmp_path / "port"))
    want_loss = step(_t(_batch(4)))["loss"].item()
    want = to_reference(dict(model.state_dict()), cfg)
    jacc, jmodel, jstep = _jax_engine(other, jm.config)
    jacc.load_state(str(tmp_path / "port"))
    np.testing.assert_allclose(float(jstep(_batch(4))["loss"]), want_loss, rtol=1e-5)
    got = jax.tree_util.tree_map(np.asarray, unbox_params(jacc.unwrap_model(jmodel).params)[0])
    JaxState._reset_state(reset_partial_state=True)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_unported_parts_and_devices_raise(monkeypatch):
    # fp8 is this port's now (tests/test_torch_fp8_models.py): the config builds and runs
    cfg = EncoderConfig.tiny(use_fp8=True, dropout_rate=0.0)
    model = EncoderClassifier(cfg, device="cpu").load_params(random_params(cfg, device="cpu"))
    with torch.no_grad():
        assert torch.isfinite(model(torch.arange(3, 11)[None])["logits"]).all()
    with pytest.raises(NotImplementedError, match="pipeline parallelism"):
        EncoderClassifier(EncoderConfig.tiny(), device="cpu", mesh={"stage": 2, "data": 4})
    with pytest.raises(NotImplementedError, match="item 10"):
        EncoderClassifier(EncoderConfig.tiny(), device="cpu", mesh={"data": 8})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EncoderClassifier(EncoderConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_params(EncoderConfig.tiny())


def test_bert_base_shape():
    cfg = EncoderConfig.bert_base()
    want = JaxConfig.bert_base()
    for field in ("vocab_size", "num_layers", "embed_dim", "num_heads", "mlp_dim",
                  "max_seq_len", "type_vocab_size", "num_labels", "dropout_rate", "norm_eps",
                  "remat"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert cfg.dtype == torch.bfloat16 and cfg.head_dim == 64


def test_dropout_replays_under_set_seed(reference):
    """Masks from the keychain's "dropout" stream: the same seed gives the
    same loss, another seed another; eval mode is the dropout-free model."""
    _, params, cfg = reference
    batch = _t(_batch(5))
    model = _port(params, EncoderConfig.tiny(dropout_rate=0.2))

    def loss(seed=None):
        if seed is not None:
            set_seed(seed)
        with torch.no_grad():
            return model(**batch)["loss"].item()

    a, b, c = loss(1), loss(1), loss(2)
    assert a == b and a != c
    model.eval()
    with torch.no_grad():
        assert loss() == _port(params, cfg)(**batch)["loss"].item()
