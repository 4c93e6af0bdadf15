"""The port's MoE decoder (``models/moe.py``, ``models/decoder.py``)
against the JAX package's, on the CPU.

- ``compute_capacity``; ``top_k_routing``'s dispatch, combine and Switch
  aux loss with slots dropped past the capacity; ``MoeMLP``'s output and
  aux against the reference module on the same weights;
- ``DecoderLM`` at ``tiny`` widths with 4 experts, top-2: logits, the
  three training losses (``loss`` = ``lm_loss`` + ``aux_loss``) and every
  gradient leaf, the router and the expert banks included; one
  ``build_train_step`` AdamW update against the JAX ``Accelerator``'s;
- ``convert.py`` both ways, ``random_params``, ``num_params``;
- a reference ``save_state`` resumed in the port and the port's in the
  reference;
- big-model dispatch of a reference MoE checkpoint on the device, host
  and disk tiers and quantized on load, against the reference's
  ``DispatchedModel``.

Inputs are numpy arrays from a seed (router probabilities drawn without
ties: ``torch.topk`` and ``lax.top_k`` order ties alike here, lower
index first, but a test should not lean on that). Both sides run in
fp32. Tolerances are stated where they are used.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu import big_modeling as RB
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.models import moe as jmoe
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.utils import serialization as RS
from accelerate_tpu.utils.quantization import QuantizationConfig as RQC
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch import big_modeling as PB
from accelerate_tpu_torch.models import moe
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.utils import serialization as PS
from accelerate_tpu_torch.utils.quantization import QuantizationConfig, QuantizedLayer

MOE = dict(moe_num_experts=4, moe_top_k=2)
B, S = 2, 32
# eps 1e-6: test_torch_seq2seq.py says why (Adam's first update at |g| ~ eps)
LR, BETAS, EPS, WD = 3e-3, (0.9, 0.999), 1e-6, 1e-4


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_close(got, want, atol_rel, what, atol=None):
    """Every leaf within ``atol_rel`` times its largest |entry| (or
    ``atol`` absolute)."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        w = np.asarray(w)
        tol = atol if atol is not None else atol_rel * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def reference():
    """(JAX model, its params as numpy, the port's config)."""
    jm = JaxLM(JaxConfig.tiny(max_seq_len=64, **MOE))
    params, _ = unbox_params(
        jm.init_variables(jax.random.PRNGKey(0), batch_size=1, seq_len=16)["params"])
    return jm, jax.tree_util.tree_map(np.asarray, params), DecoderConfig.tiny(max_seq_len=64,
                                                                               **MOE)


def _port(params, cfg, param_dtype=torch.float32):
    return DecoderLM(cfg, device="cpu", param_dtype=param_dtype).load_params(
        from_reference(params, cfg, dtype=param_dtype))


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[1, :5] = -100  # ignored targets
    return {"input_ids": ids, "labels": labels}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _probs(g, n, e, seed):
    """Router probabilities without ties: a softmax of distinct logits."""
    logits = np.random.RandomState(seed).standard_normal((g, n, e)).astype(np.float32)
    p = np.exp(logits)
    return p / p.sum(-1, keepdims=True)


# -- routing -------------------------------------------------------------------


@pytest.mark.parametrize("n,e,k,factor", [(1, 8, 2, 1.25), (5, 8, 2, 1.25), (2048, 8, 2, 1.25),
                                          (7, 4, 1, 1.0), (3, 4, 4, 0.5), (10, 3, 2, 2.0)])
def test_compute_capacity_matches_reference(n, e, k, factor):
    assert moe.compute_capacity(n, e, k, factor) == jmoe.compute_capacity(n, e, k, factor)


@pytest.mark.parametrize("g,n,e,k,capacity,drops", [(3, 10, 4, 2, 3, True),
                                                    (2, 16, 8, 2, 1, True),
                                                    (1, 6, 4, 1, 1, True),
                                                    (2, 5, 4, 2, 10, False)],
                         ids=["drops", "capacity1", "top1", "no-drops"])
def test_top_k_routing_matches_reference(g, n, e, k, capacity, drops):
    """Dispatch and combine equal to the reference's bit for bit (0 / 1
    and a gate over a renormalized pair), the aux loss to 1e-6 relative;
    the drop cases drop slots."""
    p = _probs(g, n, e, seed=g * 100 + n)
    want = [np.asarray(x) for x in jmoe.top_k_routing(jnp.asarray(p), k, capacity)]
    got = [x.numpy() for x in moe.top_k_routing(torch.as_tensor(p), k, capacity)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    assert (want[0].sum() < g * n * k) == drops


def test_top_k_breaks_ties_to_the_lower_index():
    """lax.top_k's order: equal probabilities rank by index."""
    p = torch.tensor([[[0.1, 0.3, 0.3, 0.3]]])
    vals, idx = moe._top_k(p, 3)
    assert idx.tolist() == [[[1, 2, 3]]]
    want = jax.lax.top_k(jnp.asarray(p.numpy()), 3)[1]
    assert np.asarray(want).tolist() == idx.tolist()


@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["factor1.25", "factor0.5-drops"])
def test_moe_mlp_matches_reference(factor):
    """The slot-table gather against the reference's one-hot einsums on
    the same weights, 3 groups of 10 tokens: output within 1e-5 of its
    largest entry, aux 1e-6 relative."""
    jcfg = JaxConfig.tiny(moe_capacity_factor=factor, **MOE)
    x = np.random.RandomState(5).standard_normal((3, 10, jcfg.embed_dim)).astype(np.float32)
    jm = jmoe.MoeMLP(jcfg)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    want_y, want_aux = jm.apply({"params": params}, jnp.asarray(x))
    cfg = DecoderConfig.tiny(moe_capacity_factor=factor, **MOE)
    mlp = moe.MoeMLP(cfg, "cpu", torch.float32)
    mlp.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    y, aux = mlp(torch.as_tensor(x))
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5 * np.abs(want_y).max(),
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)


# -- the decoder -----------------------------------------------------------------


def test_logits_losses_and_grads_match_reference(reference):
    """Logits within 1e-5 of their largest entry; the three losses 1e-5
    relative; each gradient leaf within 1e-4 of its largest entry (fp32
    through two layers, a 256-way softmax and the router's softmax,
    summed in another order by XLA and PyTorch)."""
    jm, params, cfg = reference
    batch = _batch(0)
    want_logits = np.asarray(jm.apply({"params": params}, jnp.asarray(batch["input_ids"]))
                             ["logits"])

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(batch["input_ids"]),
                       labels=jnp.asarray(batch["labels"]))
        return out["loss"], out

    (_, want), want_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = _port(params, cfg)
    with torch.no_grad():
        logits = model(torch.as_tensor(batch["input_ids"]))
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               atol=1e-5 * np.abs(want_logits).max(), rtol=0)
    out = model(**_t(batch))
    assert set(out) == {"loss", "lm_loss", "aux_loss"}
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["loss"].item(), (out["lm_loss"] + out["aux_loss"]).item(),
                               rtol=1e-7)
    out["loss"].backward()
    grads = to_reference({n: p.grad for n, p in model.named_parameters()}, cfg)
    _assert_trees_close(grads, want_grads, 1e-4, "grad")
    assert np.abs(grads["layers"]["block"]["moe_mlp"]["router"]).max() > 0


def test_remat_gives_the_same_grads(reference):
    """The block's (x, aux) pair through torch.utils.checkpoint: the same
    ops again, so the same gradients to 1e-6 relative."""
    _, params, cfg = reference
    batch = _t(_batch(1))
    grads = {}
    for remat in (False, True):
        model = _port(params, DecoderConfig.tiny(max_seq_len=64, remat=remat, **MOE))
        model(**batch)["loss"].backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, atol=1e-8, rtol=1e-6, msg=n)


def _jax_engine(params, jcfg):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator()
    model, _ = acc.prepare(Model(JaxLM(jcfg, mesh=acc.mesh), {"params": params}),
                           optax.adamw(LR, b1=BETAS[0], b2=BETAS[1], eps=EPS, weight_decay=WD))
    return acc, model, acc.build_train_step()


def _port_engine(params, cfg):
    acc = Accelerator(device="cpu")
    model = _port(params, cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    model, _ = acc.prepare(model, opt)
    return acc, model, acc.build_train_step()


def _jax_params(acc, model):
    return jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])


def test_one_adamw_update_matches_reference(reference):
    """``build_train_step`` trains on the MoE dict's ``loss`` (lm + aux):
    loss 1e-5 relative, grad norm 1e-4 relative and every parameter within
    2e-5 after the update (test_torch_encoder.py's limits); the eager
    forward through the prepared model surfaces all three losses."""
    jm, params, cfg = reference
    batch = _batch(2)
    jacc, jmodel, jstep = _jax_engine(params, jm.config)
    want = jstep(batch)
    want_final = _jax_params(jacc, jmodel)
    JaxState._reset_state(reset_partial_state=True)
    acc, model, step = _port_engine(params, cfg)
    got = step(_t(batch))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    _assert_trees_close(to_reference(dict(model.state_dict()), cfg), want_final, None,
                        "param", atol=2e-5)
    assert set(model(**_t(batch))) == {"loss", "lm_loss", "aux_loss"}


def test_conversion_round_trips_bit_for_bit(reference):
    _, params, cfg = reference
    back = to_reference(dict(_port(params, cfg).state_dict()), cfg)
    _assert_trees_close(back, params, None, "weight", atol=0.0)
    assert back["layers"]["block"]["moe_mlp"]["w_gate"].shape == (2, 4, 64, 128)
    assert "mlp" not in back["layers"]["block"]
    fresh = random_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    again = from_reference(to_reference(fresh, cfg), cfg, dtype=torch.float32)
    assert set(again) == set(fresh) == set(dict(_port(params, cfg).state_dict()))
    assert all(torch.equal(again[k], fresh[k]) for k in fresh)


def test_random_params_draw_at_the_reference_init_scale(reference):
    """``random_params``' router and expert banks have the standard
    deviation of the reference's initializer (flax's fan-in counts the
    expert axis: E * in), within 5% (a leaf holds 512 to 65k draws)."""
    _, params, cfg = reference
    fresh = random_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    want = params["layers"]["block"]["moe_mlp"]
    for leaf in ("router", "w_gate", "w_up", "w_down"):
        got = torch.stack([fresh[f"layers.{i}.moe_mlp.{leaf}"] for i in range(cfg.num_layers)])
        np.testing.assert_allclose(got.std().item(), np.std(want[leaf]), rtol=0.05,
                                   err_msg=leaf)


def test_config_checks_and_num_params():
    """The reference's checks and parameter count; ``small_1b`` with 8
    experts, top-2 is the 4.70B model the chip phases serve."""
    for kw in (dict(), MOE, dict(moe_num_experts=8, moe_top_k=2)):
        assert DecoderConfig.small_1b(**kw).num_params == JaxConfig.small_1b(**kw).num_params
    assert round(DecoderConfig.small_1b(moe_num_experts=8).num_params / 1e9, 2) == 4.70
    with pytest.raises(ValueError, match="0 \\(dense\\) or >= 2"):
        DecoderConfig.tiny(moe_num_experts=1)
    with pytest.raises(ValueError, match="moe_top_k"):
        DecoderConfig.tiny(moe_num_experts=2, moe_top_k=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderLM(DecoderConfig.tiny(**MOE))


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
    want = _jax_params(jacc, jmodel)
    acc, model, step = _port_engine(other, cfg)
    acc.load_state(str(tmp_path / "ref"))
    np.testing.assert_allclose(step(_t(_batch(4)))["loss"].item(), want_loss, rtol=1e-5)
    _assert_trees_close(to_reference(dict(model.state_dict()), cfg), want, None, "param",
                        atol=2e-5)

    acc, model, step = _port_engine(params, cfg)
    step(_t(_batch(3)))
    acc.save_state(str(tmp_path / "port"))
    want_loss = step(_t(_batch(4)))["loss"].item()
    want = to_reference(dict(model.state_dict()), cfg)
    jacc, jmodel, jstep = _jax_engine(other, jm.config)
    jacc.load_state(str(tmp_path / "port"))
    np.testing.assert_allclose(float(jstep(_batch(4))["loss"]), want_loss, rtol=1e-5)
    got = _jax_params(jacc, jmodel)
    JaxState._reset_state(reset_partial_state=True)
    _assert_trees_close(got, want, None, "param", atol=2e-5)


# -- big-model dispatch ------------------------------------------------------------

MAPS = {
    "all-device": "auto",
    "tiers": {"": "device", "layers": "cpu", "embedding": "disk"},
    "split-experts": {"": "device", "layers/block/moe_mlp": "cpu",
                      "layers/block/moe_mlp/w_down": "disk"},
}


@pytest.fixture(scope="module")
def ckpt(reference, tmp_path_factory):
    """The reference's MoE params saved by the reference's ``save_pytree``."""
    _, params, _ = reference
    path = str(tmp_path_factory.mktemp("moe_ckpt") / "model.safetensors")
    RS.save_pytree(params, path)
    return path


@pytest.mark.parametrize("name", list(MAPS))
def test_dispatched_logits_match_reference(reference, ckpt, tmp_path, name):
    """The same MoE checkpoint and device map through both packages'
    dispatch: the same map, logits within 1e-5; the expert banks stream
    from the host and disk tiers a layer at a time."""
    jm, _, cfg = reference
    ids = np.random.RandomState(0).randint(0, 256, (2, 16))
    ref = RB.load_checkpoint_and_dispatch(jm, ckpt, jnp.zeros((1, 8), jnp.int32),
                                          device_map=MAPS[name],
                                          offload_folder=str(tmp_path / "r"))
    want = np.asarray(ref(jnp.asarray(ids))["logits"])
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map=MAPS[name],
                                        offload_folder=str(tmp_path / "off"), device="cpu")
    assert m.device_map == ref.device_map
    np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want, atol=1e-5, rtol=1e-5)
    streamed = [w for blk in m.model.layers for w in blk.streamed]
    assert bool(streamed) == (name != "all-device")


@pytest.mark.parametrize("quant", [{"load_in_8bit": True, "group_size": 32},
                                   {"load_in_4bit": True, "group_size": 32,
                                    "quant_type": "nf4", "double_quant": True}],
                         ids=["int8", "nf4-dq"])
def test_quantized_dispatch_matches_reference(reference, ckpt, quant):
    """Quantize-on-load takes the MoE leaves as the reference does (the
    router and each stacked expert bank are eligible matrices): the same
    packed leaves bit for bit, logits within 1e-5 of the reference's
    quantized dispatch."""
    jm, _, cfg = reference
    ids = np.random.RandomState(2).randint(0, 256, (1, 32))
    ref = RB.load_checkpoint_and_dispatch(jm, ckpt, jnp.zeros((1, 32), jnp.int32),
                                          device_map="auto", quantization_config=RQC(**quant))
    want = np.asarray(ref(jnp.asarray(ids))["logits"])
    m = PB.load_checkpoint_and_dispatch(cfg, ckpt, device_map="auto",
                                        quantization_config=QuantizationConfig(**quant),
                                        device="cpu")
    np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want, atol=1e-5, rtol=1e-5)
    rflat = RS.flatten_pytree(jax.tree_util.tree_map(np.asarray, ref.params))
    pflat = PS.flatten_pytree(m.params)
    assert list(rflat) == list(pflat)
    for k in rflat:
        np.testing.assert_array_equal(np.asarray(rflat[k]), pflat[k].numpy(), err_msg=k)
    mlp = m.model.layers[1].moe_mlp
    assert all(isinstance(getattr(mlp, w), QuantizedLayer)
               for w in ("router", "w_gate", "w_up", "w_down"))
