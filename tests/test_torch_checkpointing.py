"""Training checkpoints of the port against the JAX package's, on the CPU.

- A checkpoint the JAX ``Accelerator`` saved (``optax.adamw`` with a
  warmup-cosine schedule, 3 updates of 2 micro-batches) resumes in the
  port's ``Accelerator`` built from other weights, and one the port saved
  resumes in the JAX ``Accelerator``: the 2 updates after the resume
  agree with the run that never stopped, the moments the loader read
  come back through ``optimizer_state_to_reference`` bit for bit, and
  the reference's loader really restored the port's python / numpy /
  torch generators.
- Port to port, the resumed run is bit-identical to the uninterrupted
  one (losses, learning rates, a torch draw, every parameter) through the
  eager loop with ``accumulate`` and through ``build_train_step``, over a
  shuffled and an unshuffled loader, with safetensors or pickles; a
  resume that lacks the optimizer file or the loader's position is not.
- The unshuffled loader's ``dl_state_0.bin`` cross-loads both ways; the
  seedable sampler's order depends only on (seed, epoch); ``save_state``'s
  automatic naming, ``total_limit`` rotation and "already exists" error;
  ``load_state()`` picks the newest checkpoint; registered objects and
  pre-hooks; ``save_model``'s shards and index against the reference's.

``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ 128 in fp32, every
optimizer hyperparameter given on both sides. Tolerances are stated where
they are used.
"""

import json
import os
import pickle
import random

import numpy as np
import pytest

import jax
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import GradientAccumulationPlugin as JaxAccumulation
from accelerate_tpu import Model
from accelerate_tpu.data import DataLoader as JaxDataLoader
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.utils.serialization import flatten_pytree as jax_flatten
from accelerate_tpu_torch import (Accelerator, DataLoader, ProjectConfiguration,
                                  skip_first_batches, warmup_cosine_decay_schedule)
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.checkpointing import _parse_size
from accelerate_tpu_torch.data import SeedableRandomSampler
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import (from_reference, optimizer_state_to_reference,
                                                 random_params, to_reference)
from accelerate_tpu_torch.models.decoder import DecoderLM
from accelerate_tpu_torch.utils.random import rng_state_dict, set_seed
from accelerate_tpu_torch.utils.serialization import load_flat_dict, materialize_entries

SEQ = 128
LR, BETAS, EPS, WD, CLIP = 3e-3, (0.9, 0.999), 1e-8, 1e-4, 0.1
SAVED_UPDATES, RESUMED_UPDATES, MICRO = 3, 2, 2


def _cfg():
    return DecoderConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash")


def _jax_cfg():
    return JaxConfig.tiny(num_kv_heads=2, max_seq_len=SEQ, attention_impl="flash")


def _schedule():
    return warmup_cosine_decay_schedule(0.0, LR, 2, 10)


def _ids():
    """[micro-batch, 8, SEQ] int32: the saved run's 6, then the resumed 4."""
    n = (SAVED_UPDATES + RESUMED_UPDATES) * MICRO
    return np.random.RandomState(5).randint(0, 256, (n, 8, SEQ)).astype(np.int32)


# -- the two sides' training loops -------------------------------------------


def _jax_accelerator(seed):
    """The JAX Accelerator over freshly initialised weights (``seed``),
    ``optax.adamw`` with the warmup-cosine schedule."""
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(gradient_accumulation_plugin=JaxAccumulation(num_steps=MICRO))
    definition = JaxLM(_jax_cfg(), mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(seed), batch_size=8, seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    model, opt = acc.prepare(Model(definition, variables), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10), b1=BETAS[0], b2=BETAS[1],
        eps=EPS, weight_decay=WD))
    return acc, model, opt, p0


def _jax_train(acc, model, opt, ids):
    losses = []
    for mb in ids:
        with acc.accumulate(model):
            out = model(input_ids=mb, labels=mb)
            acc.backward(out["loss"])
            acc.clip_grad_norm_(max_norm=CLIP)
            opt.step()
            opt.zero_grad()
        losses.append(float(out["loss"]))
    return losses


def _jax_params(acc, model):
    return jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])


def _port_model(seed=None, params=None):
    cfg = _cfg()
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32)
    if params is not None:
        return model.load_params(from_reference(params, cfg, dtype=torch.float32))
    return model.load_params(random_params(cfg, seed=seed, device="cpu", dtype=torch.float32))


def _port_prepare(model, loader, **acc_kw):
    acc = Accelerator(gradient_accumulation_steps=MICRO, device="cpu", **acc_kw)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=BETAS, eps=EPS, weight_decay=WD)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _schedule())
    return (acc, *acc.prepare(model, opt, sched, loader))


def _port_train(acc, model, opt, sched, batches, updates=None):
    """The eager loop over ``batches`` (an iterator), until ``updates``
    updates closed (None: to the end). Returns [(loss, lr after)]."""
    out = []
    for mb in batches:
        with acc.accumulate(model):
            loss = model(**mb)["loss"]
            acc.backward(loss)
            acc.clip_grad_norm_(max_norm=CLIP)
            opt.step()
            sched.step()
            opt.zero_grad()
        out.append((loss.item(), sched.get_last_lr()[0]))
        if acc.sync_gradients and updates is not None:
            updates -= 1
            if updates == 0:
                break
    return out


def _micro(ids):
    return [{"input_ids": mb, "labels": mb} for mb in ids]


def _assert_params_close(got, want, what):
    """Parameters within 2e-5 absolute (the bound and reason of
    test_torch_training.py::test_accelerator_tracks_reference)."""
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=2e-5, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# -- reference -> port ---------------------------------------------------------


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX Accelerator: 3 updates, save_state, 2 more updates."""
    ckpt = str(tmp_path_factory.mktemp("reference_ckpt"))
    ids = _ids()
    acc, model, opt, _ = _jax_accelerator(1)
    cut = SAVED_UPDATES * MICRO
    _jax_train(acc, model, opt, ids[:cut])
    with pytest.MonkeyPatch.context() as mp:
        # the harness's 8-device mesh spreads the weights over 8 devices,
        # where the reference writes per-rank manifests (a later slice of
        # the port); on one device it takes its consolidated path
        mp.setattr("accelerate_tpu.checkpointing._is_sharded_tree", lambda tree: False)
        acc.save_state(ckpt)
    losses = _jax_train(acc, model, opt, ids[cut:])
    final = _jax_params(acc, model)
    JaxState._reset_state(reset_partial_state=True)
    return ckpt, losses, final


@pytest.fixture(scope="module")
def port_resumed_from_reference(reference_run):
    """The port, built from other weights, loads the reference's
    checkpoint; returns the state just after the load and after 2 updates."""
    ckpt, _, _ = reference_run
    cut = SAVED_UPDATES * MICRO
    acc, model, opt, sched, loader = _port_prepare(_port_model(seed=3), _micro(_ids()[cut:]))
    acc.load_state(ckpt)
    loaded = {"moments": materialize_entries(
                  optimizer_state_to_reference(opt.optimizer, model, sched)),
              "lr": sched.get_last_lr()[0], "step": acc.step,
              "step_count": opt.step_count}
    losses = [loss for loss, _ in _port_train(acc, model, opt, sched, loader)]
    return loaded, losses, to_reference(dict(model.state_dict()), model.config), opt


def test_reference_checkpoint_moments_load_bit_for_bit(reference_run,
                                                       port_resumed_from_reference):
    ckpt, _, _ = reference_run
    loaded, _, _, _ = port_resumed_from_reference
    want = load_flat_dict(os.path.join(ckpt, "optimizer_0.safetensors"))
    got = loaded["moments"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert int(want["0/count"]) == int(want["2/count"]) == SAVED_UPDATES


def test_reference_checkpoint_restores_schedule_and_counters(reference_run,
                                                             port_resumed_from_reference):
    """optax evaluates the schedule at the update count: the 4th update
    uses schedule(3), which the loaded LambdaLR must give (1e-12 rel: the
    same expression in double)."""
    loaded, _, _, _ = port_resumed_from_reference
    assert loaded["lr"] == pytest.approx(LR * _schedule()(SAVED_UPDATES), rel=1e-12)
    assert loaded["step"] == SAVED_UPDATES * MICRO
    assert loaded["step_count"] == SAVED_UPDATES


def test_reference_checkpoint_resumes_in_the_port(reference_run, port_resumed_from_reference):
    """The 2 updates after the load: losses 1e-5 relative, parameters 2e-5
    absolute against the reference's uninterrupted run."""
    _, want_losses, want_final = reference_run
    _, losses, got_final, opt = port_resumed_from_reference
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_params_close(got_final, want_final, "param")
    assert opt.step_count == SAVED_UPDATES + RESUMED_UPDATES


# -- port -> reference ---------------------------------------------------------


@pytest.fixture(scope="module")
def port_to_reference(tmp_path_factory):
    """The port trains 3 updates and saves (then draws from python, numpy
    and torch), and trains 2 more; the JAX Accelerator, built from other
    weights, loads the checkpoint, draws, and trains the same 2."""
    ckpt = str(tmp_path_factory.mktemp("port_ckpt"))
    ids = _ids()
    cut = SAVED_UPDATES * MICRO
    acc, model, opt, sched, loader = _port_prepare(_port_model(seed=2), _micro(ids))
    batches = iter(loader)
    _port_train(acc, model, opt, sched, batches, updates=SAVED_UPDATES)
    acc.save_state(ckpt)
    port_draws = (random.random(), float(np.random.rand()), torch.rand(()).item())
    port_losses = [loss for loss, _ in _port_train(acc, model, opt, sched, batches)]
    port_final = to_reference(dict(model.state_dict()), model.config)

    jacc, jmodel, jopt, _ = _jax_accelerator(7)
    jacc.load_state(ckpt)
    jax_draws = (random.random(), float(np.random.rand()), torch.rand(()).item())
    engine = jacc._engines[0]
    jax_opt_state = {k: np.asarray(v) for k, v in jax_flatten(engine.opt_state).items()
                     if hasattr(v, "shape")}
    jax_step, jax_step_count = jacc.step, engine.step_count
    jax_losses = _jax_train(jacc, jmodel, jopt, ids[cut:])
    jax_final = _jax_params(jacc, jmodel)
    JaxState._reset_state(reset_partial_state=True)
    return dict(ckpt=ckpt, port_draws=port_draws, port_losses=port_losses,
                port_final=port_final, jax_draws=jax_draws, jax_opt_state=jax_opt_state,
                jax_step=jax_step, jax_step_count=jax_step_count, jax_losses=jax_losses,
                jax_final=jax_final)


def test_port_checkpoint_files_are_the_references(port_to_reference):
    ckpt = port_to_reference["ckpt"]
    assert sorted(os.listdir(ckpt)) == [
        "dl_state_0.bin", "model_0.safetensors", "optimizer_0.safetensors",
        "random_states_0.pkl", "scheduler_0.bin", "trainer_state.json"]
    with open(os.path.join(ckpt, "trainer_state.json")) as f:
        assert json.load(f) == {"step": SAVED_UPDATES * MICRO,
                                "engines": [{"step_count": SAVED_UPDATES}]}
    with open(os.path.join(ckpt, "random_states_0.pkl"), "rb") as f:
        assert set(pickle.load(f)) == {"python", "numpy", "keychain", "torch"}
    with open(os.path.join(ckpt, "scheduler_0.bin"), "rb") as f:
        assert pickle.load(f)["manual_steps"] == 0
    with open(os.path.join(ckpt, "dl_state_0.bin"), "rb") as f:
        assert pickle.load(f) == {"batches_yielded": SAVED_UPDATES * MICRO, "iteration": 0}
    model = load_flat_dict(os.path.join(ckpt, "model_0.safetensors"))
    assert all(k.startswith("params/") and v.dtype == torch.float32 for k, v in model.items())


def test_reference_loads_the_port_moments_bit_for_bit(port_to_reference):
    """Every array leaf of the reference's optax state after its load is
    the port file's (a leaf whose name the reference did not find would
    keep its own value, silently: hence the check by name)."""
    got = port_to_reference["jax_opt_state"]
    want = load_flat_dict(os.path.join(port_to_reference["ckpt"], "optimizer_0.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
        assert got[k].dtype == v.numpy().dtype, k
    assert port_to_reference["jax_step"] == SAVED_UPDATES * MICRO
    assert port_to_reference["jax_step_count"] == SAVED_UPDATES


def test_reference_restores_the_port_random_states(port_to_reference):
    """The reference's loader catches every exception as "Could not load
    random states": equal draws show that it ran."""
    assert port_to_reference["jax_draws"] == port_to_reference["port_draws"]


def test_port_checkpoint_resumes_in_the_reference(port_to_reference):
    """Losses 1e-5 relative, parameters 2e-5 absolute (as above)."""
    np.testing.assert_allclose(port_to_reference["jax_losses"],
                               port_to_reference["port_losses"], rtol=1e-5)
    _assert_params_close(port_to_reference["jax_final"], port_to_reference["port_final"],
                         "param")


# -- port -> port, bit for bit ---------------------------------------------------

N_SEQ = 16  # 8 micro-batches of 2, 4 updates, an epoch


def _dataset():
    data = np.random.RandomState(11).randint(0, 256, (N_SEQ, SEQ)).astype(np.int64)
    return [{"input_ids": d, "labels": d} for d in data]


def _forever(loader):
    while True:
        yield from loader


def _resume_case(tmp_path, shuffle, *, fused=False, safe=True, withhold=None):
    """Run A: 3 updates, save, 3 more (into the next epoch); run B, from
    other weights: load, 3 updates. Returns A's and B's records: (loss,
    lr) per micro-step or update, a torch draw right after the save /
    load, every parameter. ``withhold``: "optimizer" hides the optimizer
    file from the load, "loader" skips the loader's state."""
    config = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True)

    def build(seed):
        loader = DataLoader(_dataset(), batch_size=MICRO * 2 if fused else 2,
                            shuffle=shuffle, seed=0)
        return _port_prepare(_port_model(seed=seed), loader, project_config=config)

    def run(acc, model, opt, sched, batches, updates):
        if not fused:
            return _port_train(acc, model, opt, sched, batches, updates)
        step = acc.build_train_step(micro_steps=MICRO)
        return [(step(next(batches))["loss"].item(), sched.get_last_lr()[0])
                for _ in range(updates)]

    acc, model, opt, sched, loader = build(0)
    batches = _forever(loader)
    run(acc, model, opt, sched, batches, 3)
    acc.save_state(safe_serialization=safe)
    draw_a = torch.rand(4)
    rec_a = run(acc, model, opt, sched, batches, 3)
    params_a = {k: v.clone() for k, v in model.state_dict().items()}
    del batches
    acc.free_memory()

    acc, model, opt, sched, loader = build(1)
    if withhold == "loader":
        acc._dataloaders.clear()
    real_find = checkpointing._find
    with pytest.MonkeyPatch.context() as mp:
        if withhold == "optimizer":
            mp.setattr(checkpointing, "_find",
                       lambda folder, stem: None if stem.startswith("optimizer")
                       else real_find(folder, stem))
        acc.load_state()
    draw_b = torch.rand(4)
    rec_b = run(acc, model, opt, sched, _forever(loader), 3)
    params_b = dict(model.state_dict())
    return (rec_a, draw_a, params_a), (rec_b, draw_b, params_b)


def _bit_equal(a, b):
    (rec_a, draw_a, params_a), (rec_b, draw_b, params_b) = a, b
    return (rec_a == rec_b and torch.equal(draw_a, draw_b)
            and all(torch.equal(params_a[k], v) for k, v in params_b.items()))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "build_train_step"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
def test_port_resume_is_bit_exact(tmp_path, shuffle, fused):
    a, b = _resume_case(tmp_path, shuffle, fused=fused)
    assert a[0] == b[0]  # losses and learning rates
    assert torch.equal(a[1], b[1])  # the torch generator
    for k, v in b[2].items():
        assert torch.equal(a[2][k], v), k


def test_port_resume_from_pickles_is_bit_exact(tmp_path):
    a, b = _resume_case(tmp_path, True, safe=False)
    ckpt = tmp_path / "checkpoints" / "checkpoint_0"
    assert (ckpt / "model_0.bin").exists() and (ckpt / "optimizer_0.bin").exists()
    with open(ckpt / "optimizer_0.bin", "rb") as f:
        flat = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for v in flat.values()) and "0/count" in flat
    assert _bit_equal(a, b)


@pytest.mark.parametrize("withhold", ["optimizer", "loader"])
def test_resume_check_sees_a_lost_state(tmp_path, withhold):
    """A resume without the moments, or without the loader's position
    (the epoch restarts), must not pass the bit-exact check."""
    a, b = _resume_case(tmp_path, True, withhold=withhold)
    assert not _bit_equal(a, b)
    assert any(not torch.equal(a[2][k], v) for k, v in b[2].items())


# -- data loaders ------------------------------------------------------------------


def _tokens(batch):
    return np.asarray(batch["input_ids"])


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_unshuffled_loader_state_cross_loads(tmp_path, direction):
    """3 of 8 batches taken, save_state, load on the other side: its next
    batch is the fourth, and the rest of the epoch follows. (Batches of 8:
    the reference places each on the harness's 8-device mesh.)"""
    ids = np.random.RandomState(12).randint(0, 256, (64, 16)).astype(np.int32)
    data = [{"input_ids": d, "labels": d} for d in ids]
    want = [_tokens(b) for b in DataLoader(data, batch_size=8)]
    JaxState._reset_state(reset_partial_state=True)
    jacc = JaxAccelerator()
    jloader = jacc.prepare(JaxDataLoader(data, batch_size=8))
    acc = Accelerator(device="cpu")
    loader = acc.prepare(DataLoader(data, batch_size=8))
    saver, src, loader_of = ((jacc, jloader, (acc, loader)) if direction == "reference_to_port"
                             else (acc, loader, (jacc, jloader)))
    it = iter(src)
    for i in range(3):
        np.testing.assert_array_equal(_tokens(next(it)), want[i])
    saver.save_state(str(tmp_path))
    with open(tmp_path / "dl_state_0.bin", "rb") as f:
        assert pickle.load(f) == {"batches_yielded": 3, "iteration": 0}
    loader_of[0].load_state(str(tmp_path))
    got = [_tokens(b) for b in loader_of[1]]
    assert len(got) == 5
    for g, w in zip(got, want[3:]):
        np.testing.assert_array_equal(g, w)
    JaxState._reset_state(reset_partial_state=True)


def test_seedable_sampler_order_depends_on_seed_and_epoch_only():
    s = SeedableRandomSampler(10, seed=3)
    first, second = list(s), list(s)  # each pass advances the epoch
    assert sorted(first) == list(range(10)) and first != second
    s.set_epoch(0)
    assert list(s) == first
    assert list(SeedableRandomSampler(10, seed=3, epoch=1)) == second
    assert list(SeedableRandomSampler(10, seed=4)) != first
    gen = torch.Generator().manual_seed(3)
    assert first == torch.randperm(10, generator=gen).tolist()  # upstream's rule


def test_prepare_makes_a_torch_shuffle_resumable(tmp_path):
    """A torch DataLoader with a RandomSampler is rebuilt over a seedable
    sampler: its epochs repeat per (seed, epoch) and a mid-epoch resume
    gives the rest of the epoch and the next one as the run that kept on."""
    data = torch.arange(20)

    def prepared():
        acc = Accelerator(device="cpu")
        loader = torch.utils.data.DataLoader(data, batch_size=4, shuffle=True,
                                             generator=torch.Generator().manual_seed(9))
        return acc, acc.prepare(loader)

    acc, loader = prepared()
    assert isinstance(loader.loader.sampler, SeedableRandomSampler)
    assert loader.loader.sampler.seed == 9
    epochs = [[b.tolist() for b in loader] for _ in range(2)]
    assert epochs[0] != epochs[1]
    assert sorted(sum(epochs[0], [])) == list(range(20))
    acc, loader = prepared()
    it = iter(loader)
    head = [next(it).tolist() for _ in range(2)]
    acc.save_state(str(tmp_path))
    acc, loader = prepared()
    acc.load_state(str(tmp_path))
    rest = [b.tolist() for b in loader]
    assert head + rest == epochs[0]
    assert [b.tolist() for b in loader] == epochs[1]


def test_loader_state_at_the_end_of_an_epoch_starts_the_next():
    acc = Accelerator(device="cpu")
    loader = acc.prepare(DataLoader(list(range(6)), batch_size=2))
    seen = []
    for b in loader:
        seen.append(b.tolist())
        state = loader.state_dict()
    assert state == {"batches_yielded": 0, "iteration": 1}
    assert loader.state_dict() == {"batches_yielded": 0, "iteration": 1}
    other = Accelerator(device="cpu").prepare(DataLoader(list(range(6)), batch_size=2))
    other.load_state_dict(state)
    assert [b.tolist() for b in other] == seen and other.iteration == 2


def test_skip_first_batches():
    acc = Accelerator(device="cpu")
    loader = acc.prepare(DataLoader(list(range(10)), batch_size=2))
    skipped = acc.skip_first_batches(loader, 2)
    assert [b.tolist() for b in skipped] == [[4, 5], [6, 7], [8, 9]]
    assert len(list(loader)) == 5  # the original loader is untouched
    plain = skip_first_batches([[0], [1], [2]], 1)
    assert list(plain) == [[1], [2]] and len(plain) == 2


# -- checkpoint management ---------------------------------------------------------


def _small_accelerator(tmp_path, **config_kw):
    config = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                                  **config_kw)
    acc = Accelerator(device="cpu", project_config=config)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    return acc, *acc.prepare(model, opt)


def test_total_limit_rotates_by_checkpoint_index(tmp_path):
    """checkpoint_10 is newer than checkpoint_9 (by its integer, not its
    name); the oldest go first, and load_state() takes the newest."""
    acc, model, opt = _small_accelerator(tmp_path, total_limit=2, iteration=8)
    weights = []
    for _ in range(4):  # checkpoints 8, 9, 10, 11
        with torch.no_grad():
            model.weight.add_(1.0)
        weights.append(model.weight.detach().clone())
        acc.save_state()
    assert acc.save_iteration == 12
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_10", "checkpoint_11"]
    with torch.no_grad():
        model.weight.zero_()
    acc.load_state()
    assert torch.equal(model.weight, weights[-1])


def test_save_state_refuses_an_existing_checkpoint(tmp_path):
    acc, _, _ = _small_accelerator(tmp_path)
    acc.save_state()
    acc.project_configuration.iteration = 0
    with pytest.raises(ValueError, match="already exists"):
        acc.save_state()


def test_save_state_to_a_named_directory(tmp_path):
    acc = Accelerator(device="cpu", project_dir=str(tmp_path))
    assert acc.project_dir == acc.logging_dir == str(tmp_path)
    model = acc.prepare(torch.nn.Linear(3, 2))
    path = acc.save_state(str(tmp_path / "here"))
    assert path == str(tmp_path / "here")
    assert set(load_flat_dict(tmp_path / "here" / "model_0.safetensors")) == {
        "params/weight", "params/bias"}
    with pytest.raises(ValueError, match="input_dir"):
        acc.load_state()
    with pytest.raises(ValueError, match="output_dir"):
        acc.save_state()


class _Counter:
    def __init__(self):
        self.n = 0

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, state):
        self.n = state["n"]


def test_registered_objects_round_trip(tmp_path):
    acc, _, _ = _small_accelerator(tmp_path)
    counter = _Counter()
    acc.register_for_checkpointing(counter)
    counter.n = 7
    acc.save_state()
    assert (tmp_path / "checkpoints" / "checkpoint_0" / "custom_checkpoint_0.bin").exists()
    counter.n = 0
    acc.load_state()
    assert counter.n == 7
    with pytest.raises(ValueError, match="state_dict"):
        acc.register_for_checkpointing(object())


def test_pre_hooks_run_until_removed(tmp_path):
    acc, model, _ = _small_accelerator(tmp_path)
    calls = []
    save = acc.register_save_state_pre_hook(lambda *a: calls.append(("save", a)))
    load = acc.register_load_state_pre_hook(lambda *a: calls.append(("load", a)))
    path = acc.save_state()
    acc.load_state()
    assert calls == [("save", ([model], [], path)), ("load", ([model], [], path))]
    save.remove()
    load.remove()
    acc.save_state()
    acc.load_state()
    assert len(calls) == 2


def test_module_and_other_optimizer_round_trip(tmp_path):
    """Any module is saved under its own state_dict() names; an optimizer
    that is not an AdamW is saved as torch's own state_dict()."""
    acc = Accelerator(device="cpu")
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model, opt = acc.prepare(model, opt)
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    acc.save_state(str(tmp_path))
    assert (tmp_path / "optimizer_0.bin").exists()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    momentum = [opt.optimizer.state[p]["momentum_buffer"].clone() for p in model.parameters()]
    acc2 = Accelerator(device="cpu")
    model2 = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    model2, opt2 = acc2.prepare(model2, torch.optim.SGD(model2.parameters(), lr=0.1,
                                                        momentum=0.9))
    acc2.load_state(str(tmp_path))
    assert all(torch.equal(want[k], v) for k, v in model2.state_dict().items())
    for p, m in zip(model2.parameters(), momentum):
        assert torch.equal(opt2.optimizer.state[p]["momentum_buffer"], m)
    assert opt2.step_count == 1


def test_rank_manifests_raise(tmp_path):
    acc, _, _ = _small_accelerator(tmp_path)
    path = acc.save_state()
    os.remove(os.path.join(path, "model_0.safetensors"))
    open(os.path.join(path, "model_0.rank0.manifest.json"), "w").close()
    with pytest.raises(NotImplementedError, match="per-rank"):
        acc.load_state()


def test_fresh_optimizer_state_is_optax_init():
    """Before any update: count 0 and zero moments, as optax.adamw's init."""
    model = _port_model(seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    flat = materialize_entries(optimizer_state_to_reference(opt, model))
    assert int(flat["0/count"]) == 0 and "2/count" not in flat
    assert all(not v.any() for k, v in flat.items() if k != "0/count")
    with pytest.raises(TypeError, match="AdamW"):
        optimizer_state_to_reference(torch.optim.SGD(model.parameters(), lr=0.1), model)


def test_rng_state_keeps_the_reference_keychain(tmp_path):
    """A keychain the port reads is written back unchanged; set_seed
    records its seed there."""
    set_seed(5)
    assert rng_state_dict()["keychain"] == {"seed": 5, "counters": {}}
    acc, _, _ = _small_accelerator(tmp_path)
    path = acc.save_state()
    rng_file = os.path.join(path, "random_states_0.pkl")
    with open(rng_file, "rb") as f:
        state = pickle.load(f)
    state["keychain"] = {"seed": 42, "counters": {"dropout": 3}}
    with open(rng_file, "wb") as f:
        pickle.dump(state, f)
    acc.load_state()
    assert rng_state_dict()["keychain"] == {"seed": 42, "counters": {"dropout": 3}}
    set_seed(0)


def test_free_memory_drops_the_prepared_objects(tmp_path):
    acc, model, opt = _small_accelerator(tmp_path)
    acc.step = 3
    assert acc.free_memory(model, opt) == [None, None]
    assert not acc._models and not acc._optimizers and acc.step == 0


# -- save_model ------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_export(tmp_path_factory):
    """The reference's save_model of freshly initialised weights, sharded."""
    out = str(tmp_path_factory.mktemp("reference_export"))
    acc, model, _, p0 = _jax_accelerator(4)
    acc.save_model(model, out, max_shard_size="200KB")
    JaxState._reset_state(reset_partial_state=True)
    return out, p0


def test_save_model_writes_the_references_shards(reference_export, tmp_path):
    """The same weights: the same files, index, keys, shapes and dtypes,
    values bit-equal."""
    ref_dir, p0 = reference_export
    acc = Accelerator(device="cpu")
    acc.save_model(_port_model(params=p0), str(tmp_path), max_shard_size="200KB")
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(ref_dir))
    assert "model.safetensors.index.json" in os.listdir(tmp_path)
    with open(tmp_path / "model.safetensors.index.json") as f:
        got_index = json.load(f)
    with open(os.path.join(ref_dir, "model.safetensors.index.json")) as f:
        want_index = json.load(f)
    assert got_index == want_index
    got = load_flat_dict(tmp_path / "model.safetensors")
    want = load_flat_dict(os.path.join(ref_dir, "model.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_save_model_pickle_and_sizes(tmp_path):
    model = _port_model(seed=0)
    Accelerator(device="cpu").save_model(model, str(tmp_path), safe_serialization=False)
    with open(tmp_path / "model.msgpack", "rb") as f:
        flat = pickle.load(f)
    back = from_reference({k[len("params/"):]: v for k, v in flat.items()}, model.config,
                          dtype=torch.float32)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    assert _parse_size("200KB") == 200 * 1024 and _parse_size("1GB") == 1024 ** 3
    assert _parse_size("1.5MB") == int(1.5 * 1024 ** 2) and _parse_size(7) == 7


def test_accelerator_save_writes_a_tree(tmp_path):
    acc = Accelerator(device="cpu")
    acc.save({"a": torch.arange(3.0), "b": {"c": torch.ones(2)}}, str(tmp_path / "t.safetensors"))
    flat = load_flat_dict(tmp_path / "t.safetensors")
    assert set(flat) == {"a", "b/c"} and torch.equal(flat["a"], torch.arange(3.0))


def test_save_model_export_is_not_a_dispatch_checkpoint(reference_export, tmp_path):
    """save_model writes the weights under ``params/``; neither side's
    load_checkpoint_and_dispatch strips that prefix (the reference reads
    the abstract tree's own names, big_modeling.py:608), so both refuse
    the export for missing weights."""
    from accelerate_tpu.utils.modeling import load_checkpoint_in_model
    from accelerate_tpu_torch import load_checkpoint_and_dispatch

    ref_dir, p0 = reference_export
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint_in_model(p0, os.path.join(ref_dir, "model.safetensors"))
    Accelerator(device="cpu").save_model(_port_model(params=p0), str(tmp_path))
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint_and_dispatch(_cfg(), str(tmp_path / "model.safetensors"), device="cpu")
