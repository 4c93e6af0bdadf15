"""Training checkpoints crossing between the port and the JAX package, on
the CPU (split from tests/test_torch_checkpointing.py, whose helpers and
inputs these tests share: ``DecoderConfig.tiny(num_kv_heads=2)`` at SEQ
128 in fp32, every optimizer hyperparameter given on both sides).

- A checkpoint the JAX ``Accelerator`` saved (``optax.adamw`` with a
  warmup-cosine schedule, 3 updates of 2 micro-batches) resumes in the
  port's ``Accelerator`` built from other weights, and one the port saved
  resumes in the JAX ``Accelerator``: the 2 updates after the resume
  agree with the run that never stopped, the moments the loader read
  come back through ``optimizer_state_to_reference`` bit for bit, and
  the reference's loader really restored the port's python / numpy /
  torch generators.
- ``save_model``'s shards and index against the reference's.

Tolerances are stated where they are used.
"""

import json
import os
import pickle
import random

import numpy as np
import pytest

import torch

from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.utils.serialization import flatten_pytree as jax_flatten
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.checkpointing import _parse_size
from accelerate_tpu_torch.models.convert import (from_reference, optimizer_state_to_reference,
                                                 to_reference)
from accelerate_tpu_torch.utils.serialization import load_flat_dict, materialize_entries
from test_torch_checkpointing import (LR, MICRO, RESUMED_UPDATES, SAVED_UPDATES,
                                      _assert_params_close, _cfg, _ids, _jax_accelerator,
                                      _jax_params, _jax_train, _micro, _port_model,
                                      _port_prepare, _port_train, _schedule)


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
