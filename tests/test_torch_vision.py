"""The port's ResNet (``models/vision.py``) against the JAX package's, on
the CPU.

- XLA's SAME padding at stride 2 on even inputs (asymmetric: (0, 1) for
  a 3x3, (2, 3) for the 7x7 stem) and on odd ones, for the conv and the
  3x3/2 max pool, against flax's ``nn.Conv`` / ``nn.max_pool``;
- the basic-block and bottleneck-block tiny models, on the cifar and the
  imagenet stem, in eval and in train mode: logits, loss and every
  gradient leaf; the BatchNorm running statistics after a train forward;
- one SGD-momentum update of ``optax.sgd(0.1, momentum=0.9)`` (the
  bench's optimizer) through the eager loop of the JAX ``Accelerator``
  against a torch ``SGD`` through the port's, with and without bf16
  mixed precision (the BatchNorm scale and bias and the classifier take
  the cast too): parameters, statistics and the loss after;
- ``convert.py`` both ways, the zero-initialized last BatchNorm scales;
- ``save_state`` / ``load_state`` both ways (params, ``batch_stats`` and
  the momentum trace), each side resuming the other's files; the
  ``save_model`` export's names.

Inputs are numpy arrays from a seed; both sides run in fp32 at
``VisionConfig.tiny`` widths. Tolerances are stated where they are used.
"""

import os

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import ResNet as JaxResNet
from accelerate_tpu.models import VisionConfig as JaxConfig
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import ResNet, VisionConfig
from accelerate_tpu_torch.models.convert import from_reference, random_params, to_reference
from accelerate_tpu_torch.models.vision import Conv, same_padding
from accelerate_tpu_torch.utils.serialization import load_flat_dict

B = 4
LR, MOMENTUM = 0.1, 0.9
VARIANTS = {
    "basic-cifar": dict(block="basic", stem="cifar", image_size=16),
    "bottleneck-cifar": dict(block="bottleneck", stem="cifar", image_size=16),
    "basic-imagenet": dict(block="basic", stem="imagenet", image_size=32),
    "bottleneck-imagenet-odd": dict(block="bottleneck", stem="imagenet", image_size=30),
}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_close(got, want, what, rel=None, atol=None):
    """Every leaf within ``rel`` times its largest |entry|, or ``atol``."""
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want), what
    for (path, w), (_, g) in zip(_leaves(want), _leaves(got)):
        w = np.asarray(w)
        tol = atol if atol is not None else rel * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _variables(name, seed=0):
    """The reference model of a variant and its variables (numpy), with
    BatchNorm scales, biases and running statistics moved off their init
    so every term of the normalization is exercised."""
    jcfg = JaxConfig.tiny(**VARIANTS[name])
    jm = JaxResNet(jcfg)
    v = jm.init_variables(jax.random.PRNGKey(seed), batch_size=1,
                          image_size=jcfg.image_size)
    v = jax.tree_util.tree_map(np.asarray, nn.unbox(v))
    rng = np.random.RandomState(seed + 10)

    def shift(a):
        return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32) if a.ndim == 1 else a

    params = jax.tree_util.tree_map(shift, v["params"])
    stats = jax.tree_util.tree_map(lambda a: np.abs(shift(a)) + 0.1, v["batch_stats"])
    return jm, {"params": params, "batch_stats": stats}, VisionConfig.tiny(**VARIANTS[name])


def _port(variables, cfg):
    return ResNet(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(variables, cfg, dtype=torch.float32))


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    s = cfg.image_size
    return (rng.standard_normal((B, s, s, 3)).astype(np.float32),
            rng.randint(0, cfg.num_classes, (B,)))


def _port_state(model, cfg):
    ref = to_reference(dict(model.state_dict()), cfg)
    return {"batch_stats": ref.pop("batch_stats"), "params": ref}


# -- SAME padding ----------------------------------------------------------------


@pytest.mark.parametrize("size,kernel,stride,want", [
    (8, 3, 2, (0, 1)), (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (9, 3, 2, (1, 1)),
    (8, 1, 2, (0, 0)), (8, 3, 1, (1, 1)), (7, 7, 2, (3, 3))])
def test_same_padding_is_xlas(size, kernel, stride, want):
    assert same_padding(size, kernel, stride) == want


@pytest.mark.parametrize("size", [8, 10, 9])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (7, 2), (1, 2), (3, 1)])
def test_conv_same_padding_matches_flax(size, kernel, stride):
    """The conv against flax's ``nn.Conv`` (SAME) on the same kernel:
    within 1e-5 of the output's largest entry (an fp32 contraction summed
    in another order)."""
    rng = np.random.RandomState(size * 10 + kernel)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 3, 5)).astype(np.float32)
    want = np.asarray(nn.Conv(5, (kernel, kernel), strides=(stride, stride), use_bias=False)
                      .apply({"params": {"kernel": w}}, jnp.asarray(x)))
    conv = Conv(3, 5, kernel, stride, VisionConfig.tiny(), "cpu", torch.float32)
    conv.kernel.data.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("size", [8, 16, 9])
def test_max_pool_same_padding_matches_flax(size):
    """The stem's 3x3/2 max pool: the padded cells are -inf, so a window
    over the high edge takes its real maximum (exact)."""
    model = _port(*_variables("basic-imagenet")[1:])
    x = np.random.RandomState(size).standard_normal((2, size, size, 4)).astype(np.float32) - 5.0
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = model.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


# -- the model ---------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_loss_and_grads_match_reference(name, train):
    """Logits within 1e-5 of their largest entry, the loss 1e-5 relative,
    each gradient leaf within 1e-4 of its largest entry (fp32 convs and
    BatchNorm statistics summed in another order); in train mode the
    running statistics after the forward within 1e-5 of each leaf's
    largest entry (the variance as E[x^2] - E[x]^2 cancels digits)."""
    jm, variables, cfg = _variables(name)
    x, y = _batch(cfg, 1)

    def jloss(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            out, new = jm.apply(v, jnp.asarray(x), labels=jnp.asarray(y), train=True,
                                mutable=["batch_stats"])
        else:
            out, new = jm.apply(v, jnp.asarray(x), labels=jnp.asarray(y)), {}
        return out["loss"], (out["logits"], new)

    (loss, (logits, new)), grads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    model = _port(variables, cfg)
    out = model(torch.from_numpy(x), torch.from_numpy(y), train=train)
    logits = np.asarray(logits)
    np.testing.assert_allclose(out["logits"].detach().numpy(), logits,
                               atol=1e-5 * np.abs(logits).max(), rtol=0)
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5)
    out["loss"].backward()
    got = to_reference({n: p.grad for n, p in model.named_parameters()}, cfg)
    _assert_trees_close(got, grads, "grad", rel=1e-4)
    stats = _port_state(model, cfg)["batch_stats"]
    want_stats = new["batch_stats"] if train else variables["batch_stats"]
    _assert_trees_close(stats, jax.tree_util.tree_map(np.asarray, want_stats), "stats",
                        rel=1e-5)


def test_conversion_round_trips_and_random_init():
    """``to_reference`` gives the reference's variables bit for bit (conv
    kernels back to HWIO); ``random_params`` zeroes each block's last
    BatchNorm scale, as the reference's ``scale_init``."""
    _, variables, cfg = _variables("bottleneck-imagenet-odd")
    state = _port_state(_port(variables, cfg), cfg)
    _assert_trees_close(state, variables, "weight", atol=0.0)
    fresh = random_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    again = from_reference(to_reference(fresh, cfg), cfg, dtype=torch.float32)
    assert set(again) == set(fresh) == set(_port(variables, cfg).state_dict())
    assert all(torch.equal(again[k], fresh[k]) for k in fresh)
    zero = sorted(k for k, v in fresh.items() if k.endswith(".scale") and not v.any())
    assert zero == ["stage0_block0.BatchNorm_2.scale", "stage1_block0.BatchNorm_2.scale"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet(cfg)


def test_resnet50_shapes():
    """The bench's ResNet-50: 25.56M parameters (torchvision's count),
    conv kernels OIHW, no parameter stored below fp32 for training."""
    cfg = VisionConfig.resnet50()
    model = ResNet(cfg, device="meta", param_dtype=torch.float32)
    n = sum(p.numel() for p in model.parameters())
    assert n == 25_557_032
    assert tuple(model.stem_conv.kernel.shape) == (64, 3, 7, 7)
    assert tuple(model.stage3_block2.Conv_2.kernel.shape) == (2048, 512, 1, 1)
    assert VisionConfig.resnet101().stage_sizes == (3, 4, 23, 3)


def _jax_engine(variables, jm, mixed_precision="no"):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(mixed_precision=mixed_precision)
    model, opt = acc.prepare(Model(jm, variables), optax.sgd(LR, momentum=MOMENTUM))
    return acc, model, opt


def _jax_step(model, opt, acc, batch):
    x, y = batch
    out = model(jnp.asarray(x), labels=jnp.asarray(y), train=True)
    acc.backward(out["loss"])
    opt.step()
    opt.zero_grad()
    return float(out["loss"])


def _port_engine(variables, cfg, mixed_precision="no"):
    acc = Accelerator(mixed_precision=mixed_precision, device="cpu")
    model = _port(variables, cfg)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt


def _port_step(model, opt, acc, batch):
    x, y = batch
    out = model(torch.from_numpy(x), torch.from_numpy(y), train=True)
    acc.backward(out["loss"])
    opt.step()
    opt.zero_grad()
    return out["loss"].item()


def _jax_state(acc, model):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(acc.get_state_dict(model)))


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_one_sgd_momentum_update_matches_reference(mixed_precision):
    """Two eager updates of optax.sgd(0.1, momentum=0.9) against torch's
    SGD (the second one reads the momentum trace): losses 1e-5 relative
    (bf16: the same rounded parameters on both sides, 1e-4), parameters
    within 2e-5 absolute (bf16: 2e-4) and the running statistics within
    1e-5 (bf16: 1e-4) of each leaf's largest entry after them."""
    jm, variables, cfg = _variables("bottleneck-imagenet-odd")
    tol = {"no": (1e-5, 2e-5, 1e-5), "bf16": (1e-4, 2e-4, 1e-4)}[mixed_precision]
    batches = [_batch(cfg, 2), _batch(cfg, 3)]
    jacc, jmodel, jopt = _jax_engine(variables, jm, mixed_precision)
    want = [_jax_step(jmodel, jopt, jacc, b) for b in batches]
    want_state = _jax_state(jacc, jmodel)
    JaxState._reset_state(reset_partial_state=True)
    acc, model, opt = _port_engine(variables, cfg, mixed_precision)
    got = [_port_step(model, opt, acc, b) for b in batches]
    np.testing.assert_allclose(got, want, rtol=tol[0])
    state = _port_state(model, cfg)
    _assert_trees_close(state["params"], want_state["params"], "param", atol=tol[1])
    _assert_trees_close(state["batch_stats"], want_state["batch_stats"], "stats", rel=tol[2])
    for buf in model.buffers():
        assert buf.dtype == torch.float32  # statistics are never cast


def test_build_train_step_updates_statistics():
    """The fused step (the bench's form: a loss_fn calling ``train=True``,
    ``steps_per_call=2``) trains: a finite loss, the parameters and the
    BatchNorm statistics move."""
    _, variables, cfg = _variables("basic-cifar")
    acc, model, _ = _port_engine(variables, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = _batch(cfg, 4)
    step = acc.build_train_step(
        loss_fn=lambda m, b: m(b["images"], b["labels"], train=True)["loss"], steps_per_call=2)
    batch = {"images": torch.from_numpy(np.stack([x, x])), "labels": torch.from_numpy(
        np.stack([y, y]))}
    out = step(batch)
    assert np.isfinite(out["loss_mean"].item())
    after = model.state_dict()
    assert all(not torch.equal(after[k], before[k]) for k in ("stem_bn.mean", "stem_bn.var",
                                                             "stem_conv.kernel"))


def test_checkpoints_cross_load_and_resume(tmp_path, monkeypatch):
    """Each side takes one update and saves (params, batch_stats, the
    momentum trace); the other side, built over other weights, loads it
    and takes the next update: loss 1e-5 relative, parameters 2e-5
    absolute and statistics 1e-5 of each leaf's largest entry against the
    saving side's own next update.
    The files hold the reference's names."""
    jm, variables, cfg = _variables("basic-imagenet")
    _, other, _ = _variables("basic-imagenet", seed=5)
    batches = [_batch(cfg, 5), _batch(cfg, 6)]
    monkeypatch.setattr("accelerate_tpu.checkpointing._is_sharded_tree", lambda tree: False)

    jacc, jmodel, jopt = _jax_engine(variables, jm)
    _jax_step(jmodel, jopt, jacc, batches[0])
    jacc.save_state(str(tmp_path / "ref"))
    want_loss = _jax_step(jmodel, jopt, jacc, batches[1])
    want = _jax_state(jacc, jmodel)
    JaxState._reset_state(reset_partial_state=True)
    acc, model, opt = _port_engine(other, cfg)
    acc.load_state(str(tmp_path / "ref"))
    np.testing.assert_allclose(_port_step(model, opt, acc, batches[1]), want_loss, rtol=1e-5)
    state = _port_state(model, cfg)
    _assert_trees_close(state["params"], want["params"], "param", atol=2e-5)
    _assert_trees_close(state["batch_stats"], want["batch_stats"], "stats", rel=1e-5)

    acc, model, opt = _port_engine(variables, cfg)
    _port_step(model, opt, acc, batches[0])
    acc.save_state(str(tmp_path / "port"))
    for name in ("optimizer_0.safetensors", "model_0.safetensors"):
        ours = load_flat_dict(str(tmp_path / "port" / name))
        theirs = load_flat_dict(str(tmp_path / "ref" / name))
        assert set(ours) == set(theirs), name
        assert {tuple(v.shape) for v in ours.values()} == {tuple(v.shape)
                                                           for v in theirs.values()}
    want_loss = _port_step(model, opt, acc, batches[1])
    want = _port_state(model, cfg)
    jacc, jmodel, jopt = _jax_engine(other, jm)
    jacc.load_state(str(tmp_path / "port"))
    np.testing.assert_allclose(_jax_step(jmodel, jopt, jacc, batches[1]), want_loss, rtol=1e-5)
    got = _jax_state(jacc, jmodel)
    JaxState._reset_state(reset_partial_state=True)
    _assert_trees_close(got["params"], want["params"], "param", atol=2e-5)
    _assert_trees_close(got["batch_stats"], want["batch_stats"], "stats", rel=1e-5)


@pytest.mark.parametrize("options, written", [
    (dict(weight_decay=1e-4), "optimizer_0.safetensors"),
    (dict(weight_decay=1e-4, nesterov=True), "optimizer_0.safetensors"),
    (dict(weight_decay=1e-4, dampening=0.1), "optimizer_0.bin"),
])
def test_sgd_options_save_and_resume(tmp_path, options, written):
    """An SGD with weight decay (the ResNet recipe) or nesterov keeps
    optax.sgd's trace form and saves as the reference's ``0/trace/...``;
    a dampened one has no optax form and saves as torch's own
    ``state_dict()``. Either resumes in the port bit for bit: the loaded
    side's next update equals the saving side's own."""
    _, variables, cfg = _variables("basic-cifar")
    _, other, _ = _variables("basic-cifar", seed=5)
    batches = [_batch(cfg, 5), _batch(cfg, 6)]

    def engine(v):
        acc = Accelerator(device="cpu")
        model = _port(v, cfg)
        opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM, **options)
        model, opt = acc.prepare(model, opt)
        return acc, model, opt

    acc, model, opt = engine(variables)
    _port_step(model, opt, acc, batches[0])
    acc.save_state(str(tmp_path))
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("optimizer")) == [written]
    if written.endswith(".safetensors"):
        keys = set(load_flat_dict(str(tmp_path / written)))
        assert keys and all(k.startswith("0/trace/") for k in keys)
    want_loss = _port_step(model, opt, acc, batches[1])
    want = {k: v.clone() for k, v in model.state_dict().items()}
    acc, model, opt = engine(other)
    acc.load_state(str(tmp_path))
    assert _port_step(model, opt, acc, batches[1]) == want_loss
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_save_model_export_names(tmp_path):
    """``save_model`` writes the reference's export: ``params/...`` and
    ``batch_stats/...``, HWIO kernels."""
    _, variables, cfg = _variables("basic-cifar")
    acc, model, _ = _port_engine(variables, cfg)
    acc.save_model(model, str(tmp_path))
    flat = load_flat_dict(str(tmp_path / "model.safetensors"))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in _leaves(variables)}
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
