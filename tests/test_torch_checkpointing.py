"""Training checkpoints of the port against the JAX package's, on the CPU,
and the helpers of the files split from this one (so that pytest's
``--dist loadfile`` spreads them over workers):
tests/test_torch_checkpointing_reference.py (checkpoints crossing between
the two packages both ways; ``save_model`` against the reference's) and
tests/test_torch_checkpointing_resume.py (port-to-port resumes bit for
bit, through ``_resume_case`` here) and
tests/test_torch_checkpointing_resume_controls.py (a resume from pickles,
and the resumes that lack the optimizer file or the loader's position).

- The unshuffled loader's ``dl_state_0.bin`` cross-loads both ways; the
  seedable sampler's order depends only on (seed, epoch); ``save_state``'s
  automatic naming, ``total_limit`` rotation and "already exists" error;
  ``load_state()`` picks the newest checkpoint; registered objects and
  pre-hooks; the fresh optimizer state, the RNG keychain and
  ``free_memory``.

``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ 128 in fp32, every
optimizer hyperparameter given on both sides. Tolerances are stated where
they are used.
"""

import os
import pickle

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
from accelerate_tpu_torch import (Accelerator, DataLoader, ProjectConfiguration,
                                  skip_first_batches, warmup_cosine_decay_schedule)
from accelerate_tpu_torch import checkpointing
from accelerate_tpu_torch.data import SeedableRandomSampler
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import (from_reference, optimizer_state_to_reference,
                                                 random_params)
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


def test_rank_manifests_are_read(tmp_path):
    """A checkpoint in the reference's per-rank layout (the weights and
    the moments each split over two ranks' manifests) loads as its
    single-file form does; a rank's missing manifest raises."""
    from accelerate_tpu_torch.utils.serialization import save_entries_dist

    acc, model, opt = _small_accelerator(tmp_path)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    saved = [t.detach().clone() for t in (model.weight, model.bias)]
    moments = {k: v.clone() for k, v in opt.optimizer.state[model.weight].items()}
    path = acc.save_state()
    for stem in ("model_0", "optimizer_0"):
        flat = load_flat_dict(os.path.join(path, stem + ".safetensors"))
        entries = [(k, tuple(v.shape), v.dtype, (lambda t: lambda: t)(v.clone()))
                   for k, v in flat.items()]
        for rank in range(2):
            save_entries_dist(entries, os.path.join(path, stem), rank, 2)
        os.remove(os.path.join(path, stem + ".safetensors"))
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    opt.optimizer.state.clear()
    acc.load_state()
    assert torch.equal(model.weight, saved[0]) and torch.equal(model.bias, saved[1])
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(opt.optimizer.state[model.weight][key], moments[key])
    os.remove(os.path.join(path, "model_0.rank1.manifest.json"))
    with pytest.raises(ValueError, match="incomplete"):
        acc.load_state()


def test_fresh_optimizer_state_is_optax_init():
    """Before any update: count 0 and zero moments, as optax.adamw's init."""
    model = _port_model(seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    flat = materialize_entries(optimizer_state_to_reference(opt, model))
    assert int(flat["0/count"]) == 0 and "2/count" not in flat
    assert all(not v.any() for k, v in flat.items() if k != "0/count")
    with pytest.raises(TypeError, match="AdamW"):
        optimizer_state_to_reference(torch.optim.Adagrad(model.parameters(), lr=0.1), model)


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
