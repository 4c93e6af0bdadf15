"""Checkpoint and resume of a training run, in the reference's format.

Counterpart of ``accelerate_tpu/checkpointing.py``. A checkpoint
directory holds the reference's files, so a run saved by either side
resumes on the other:

  model_<i>.safetensors   the weights under ``params/``; a port model's
                          (``DecoderLM``, ``Seq2SeqLM``,
                          ``EncoderClassifier``, ``ResNet``) in the
                          reference's names and layout, a ResNet's
                          BatchNorm statistics under
                          ``extra_state/batch_stats/``, a delayed fp8
                          model's amax histories under
                          ``extra_state/fp8_stats/`` (kept, with one
                          warning, where a checkpoint lacks them)
  optimizer_<i>.safetensors  a torch ``AdamW``'s state as ``optax.adamw``'s
                          (``0/count``, ``0/mu/...``, ``0/nu/...``, and
                          ``2/count`` under a ``LambdaLR``), or a torch
                          ``SGD``'s as ``optax.sgd``'s (``0/trace/...``,
                          ``1/count``)
  scheduler_<i>.bin       ``{"manual_steps": 0, "torch": <its state>}``
  dl_state_<i>.bin        ``{"batches_yielded", "iteration"}``
  random_states_0.pkl     python, numpy, torch (+ CUDA) generators and
                          the keychain, the dropout stream's position
  custom_checkpoint_<i>.bin  objects given to ``register_for_checkpointing``
  trainer_state.json      ``{"step", "engines": [{"step_count"}]}``, and
                          under fp16 each engine's ``"scale"``:
                          ``{"scale", "growth_tracker"}``

Model ``i`` and the optimizer over its parameters are the reference's
engine ``i``. Weights and moments are written a layer slice at a time
(``models/convert.reference_entries``), so the host never holds a
stacked leaf twice; on load every tensor is copied into a tensor on the
device of the parameter it belongs to. A module other than the port's
models is written under its own ``state_dict()`` names, and an AdamW over it
under its parameter names: such a checkpoint has no reference
counterpart. An optimizer that is not an ``AdamW`` (or an undampened
``SGD`` over a port model) over exactly its model's parameters is written
as torch's own ``state_dict()`` in ``optimizer_<i>.bin``, which only the
port reads. ``safe_serialization=False`` writes pickles of numpy arrays
(``.bin``) in place of safetensors, as the reference does.

Not carried: the reference's per-rank manifests of a sharded save
(``save_pytree_dist``; the port's ``load_flat_dict`` raises on them). The
port keeps one loss scale for all its engines (the Accelerator's): it
writes it into every engine's entry and loads engine 0's.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import warnings
from typing import Optional

import numpy as np
import torch

from .models.convert import (from_reference, layout_config, locate,
                             optimizer_state_from_reference, optimizer_state_to_reference,
                             reference_entries, sgd_has_optax_state)
from .utils.constants import (CUSTOM_STATE_PATTERN, DATALOADER_STATE_NAME, MODEL_NAME,
                              OPTIMIZER_NAME, RNG_STATE_NAME, SAFE_WEIGHTS_NAME,
                              SCHEDULER_NAME, WEIGHTS_NAME)
from .utils.phases import phase
from .utils.random import load_rng_state_dict, rng_state_dict
from .utils.serialization import (flatten_pytree, load_flat_dict, materialize_entries,
                                  save_entries, save_pytree)

logger = logging.getLogger(__name__)

PARAMS = "params/"
EXTRA_STATE = "extra_state/"


def _model_entries(model, buffer_prefix: str = EXTRA_STATE) -> list:
    """``(key, shape, dtype, fetch)`` entries of a model's weights under
    ``params/``: a port model's in the reference's layout (its buffers, a
    ResNet's ``batch_stats/...``, under ``buffer_prefix``: the engine's
    ``extra_state/`` in a checkpoint, top-level in ``save_model``'s
    export), any other module's (or tree's) under its own names."""
    config = layout_config(model)
    if config is not None:
        return reference_entries(dict(model.state_dict()), config, prefix=PARAMS,
                                 buffer_prefix=buffer_prefix)
    tree = model.state_dict() if isinstance(model, torch.nn.Module) else model
    return [(PARAMS + k, tuple(t.shape), t.dtype, (lambda t: lambda: t.detach())(t))
            for k, t in flatten_pytree(tree).items()]


def _write(entries, stem: str, safe_serialization: bool,
           max_shard_size: Optional[int] = None) -> list:
    if safe_serialization:
        return save_entries(entries, stem + ".safetensors", max_shard_size)
    return save_pytree(materialize_entries(entries), stem + ".bin", safe_serialization=False)


def _pickle(obj, path: str):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _unpickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _param_ids(params) -> set:
    return {id(p) for p in params}


def _engines(models, optimizers, schedulers) -> list:
    """(model, its optimizer or None, that optimizer's scheduler or None)
    per model: the optimizer whose parameters are the model's, and the
    scheduler built over that optimizer."""
    out = []
    for model in models:
        own = _param_ids(model.parameters())
        opt = next((o for o in optimizers if _param_ids(o.parameters()) <= own), None)
        sched = None
        if opt is not None:
            sched = next((s for s in schedulers
                          if getattr(s.scheduler, "optimizer", None) in (opt, opt.optimizer)),
                         None)
        out.append((model, opt, sched))
    return out


def _reference_optimizer(opt, model) -> bool:
    """True when ``opt`` is over exactly ``model``'s parameters and is an
    AdamW (optax.adamw's form), or an SGD over a port model whose momentum
    is optax.sgd's trace (as the reference's ResNet trains); any other SGD
    (over another module, or dampened) keeps torch's own state_dict()."""
    inner = opt.optimizer
    ours = isinstance(inner, torch.optim.AdamW) or (
        isinstance(inner, torch.optim.SGD) and layout_config(model) is not None
        and sgd_has_optax_state(inner))
    return ours and _param_ids(opt.parameters()) == _param_ids(model.parameters())


def save_accelerator_state(output_dir: str, models=(), optimizers=(), schedulers=(),
                           dataloaders=(), custom_objects=(), step: int = 0,
                           safe_serialization: bool = True, loss_scale=None) -> str:
    """Write every prepared object's state into ``output_dir`` (the
    reference's checkpointing.py:51). ``step`` is the Accelerator's,
    ``loss_scale`` its fp16 loss scale (``accelerator.LossScale``) or None. The
    write runs inside ``phase("checkpoint/save")``, as the reference's: a
    span when a telemetry session records spans, and seconds in an armed
    goodput ledger's checkpoint bucket."""
    with phase("checkpoint/save"):
        return _save_accelerator_state(output_dir, models, optimizers, schedulers,
                                       dataloaders, custom_objects, step,
                                       safe_serialization, loss_scale)


def _save_accelerator_state(output_dir, models, optimizers, schedulers, dataloaders,
                            custom_objects, step, safe_serialization, loss_scale) -> str:
    os.makedirs(output_dir, exist_ok=True)
    trainer_state = {"step": step, "engines": []}
    for i, (model, opt, sched) in enumerate(_engines(models, optimizers, schedulers)):
        _write(_model_entries(model), os.path.join(output_dir, f"{MODEL_NAME}_{i}"),
               safe_serialization)
        stem = os.path.join(output_dir, f"{OPTIMIZER_NAME}_{i}")
        if opt is not None and _reference_optimizer(opt, model):
            _write(optimizer_state_to_reference(opt.optimizer, model, sched), stem,
                   safe_serialization)
        elif opt is not None:
            _pickle(opt.state_dict(), stem + ".bin")
        meta = {"step_count": opt.step_count if opt else 0}
        if loss_scale is not None:
            # floats, as the reference writes them
            meta["scale"] = {k: float(v) for k, v in loss_scale.state_dict().items()}
        trainer_state["engines"].append(meta)
    for i, sched in enumerate(schedulers):
        _pickle(sched.state_dict(), os.path.join(output_dir, f"{SCHEDULER_NAME}_{i}.bin"))
    for i, dl in enumerate(dataloaders):
        if hasattr(dl, "state_dict"):
            _pickle(dl.state_dict(),
                    os.path.join(output_dir, f"{DATALOADER_STATE_NAME}_{i}.bin"))
    for i, obj in enumerate(custom_objects):
        save_custom_state(obj, output_dir, i)
    with open(os.path.join(output_dir, "trainer_state.json"), "w") as f:
        json.dump(trainer_state, f, indent=2)
    _pickle(rng_state_dict(), os.path.join(output_dir, f"{RNG_STATE_NAME}_0.pkl"))
    return output_dir


def _load_optimizer(path: str, opt, model, sched):
    if path.endswith(".bin"):
        state = _unpickle(path)
        if "param_groups" in state:  # torch's own state_dict()
            opt.load_state_dict(state)
            return
        flat = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    else:
        flat = load_flat_dict(path)
    optimizer_state_from_reference(flat, opt.optimizer, model, sched)


def load_accelerator_state(input_dir: str, models=(), optimizers=(), schedulers=(),
                           dataloaders=(), custom_objects=(), loss_scale=None) -> Optional[int]:
    """Load what :func:`save_accelerator_state` (or the reference's) wrote
    into the prepared objects, in place (the reference's
    checkpointing.py:164). Files a checkpoint lacks leave their object as
    it is; ``loss_scale`` takes engine 0's ``"scale"`` entry when there is
    one. Returns the saved ``step``, or None. Runs inside
    ``phase("checkpoint/restore")``, as the reference's."""
    with phase("checkpoint/restore"):
        return _load_accelerator_state(input_dir, models, optimizers, schedulers,
                                       dataloaders, custom_objects, loss_scale)


def _load_accelerator_state(input_dir, models, optimizers, schedulers, dataloaders,
                            custom_objects, loss_scale) -> Optional[int]:
    trainer_state = {}
    ts_path = os.path.join(input_dir, "trainer_state.json")
    if os.path.exists(ts_path):
        with open(ts_path) as f:
            trainer_state = json.load(f)
    metas = trainer_state.get("engines") or []
    if loss_scale is not None and metas and "scale" in metas[0]:
        loss_scale.load_state_dict(metas[0]["scale"])
    for i, (model, opt, sched) in enumerate(_engines(models, optimizers, schedulers)):
        path = _find(input_dir, f"{MODEL_NAME}_{i}")
        if path is None:
            continue
        flat = load_flat_dict(path)
        params = {k[len(PARAMS):]: v for k, v in flat.items() if k.startswith(PARAMS)}
        if not params:  # the reference's files from before extra_state: flat IS params
            params = {k: v for k, v in flat.items() if not k.startswith(EXTRA_STATE)}
        config = layout_config(model)
        if config is not None:
            # a port model's buffers (a ResNet's batch_stats/..., the fp8
            # amax histories' fp8_stats/...) sit under extra_state/
            params.update({k[len(EXTRA_STATE):]: v for k, v in flat.items()
                           if k.startswith(EXTRA_STATE)})
            weights = from_reference(params, config)
            _warn_kept(sorted(set(model.fp8_histories()) - set(weights)), config)
            model.load_params(weights)
        else:
            model.load_state_dict(params, strict=True)
        opt_path = _find(input_dir, f"{OPTIMIZER_NAME}_{i}")
        if opt is not None and opt_path is not None:
            _load_optimizer(opt_path, opt, model, sched)
        if opt is not None:
            opt.step_count = int((metas[i] if i < len(metas) else {}).get("step_count", 0))
    for i, sched in enumerate(schedulers):
        p = os.path.join(input_dir, f"{SCHEDULER_NAME}_{i}.bin")
        if os.path.exists(p):
            sched.load_state_dict(_unpickle(p))
    for i, dl in enumerate(dataloaders):
        p = os.path.join(input_dir, f"{DATALOADER_STATE_NAME}_{i}.bin")
        if os.path.exists(p) and hasattr(dl, "load_state_dict"):
            dl.load_state_dict(_unpickle(p))
    for i, obj in enumerate(custom_objects):
        if os.path.exists(os.path.join(input_dir, CUSTOM_STATE_PATTERN.format(i) + ".bin")):
            load_custom_state(obj, input_dir, i)
    rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_0.pkl")
    if os.path.exists(rng_path):
        load_rng_state_dict(_unpickle(rng_path))
    return trainer_state.get("step")


def _warn_kept(names: list, config):
    """One warning for the amax histories a checkpoint lacks (an older
    checkpoint, or one saved before the delayed recipe was on): they keep
    their current values, as the reference's ``missing="keep"`` restore of
    its extra state does."""
    if names:
        warnings.warn(
            f"{len(names)} state entries absent from the checkpoint kept their current "
            f"(fresh) values, e.g. {locate(names[0], config)[0]!r}: expected when "
            "resuming a checkpoint saved without these fp8 amax histories",
            stacklevel=4)


def save_custom_state(obj, path: str, index: int = 0, save_on_each_node: bool = False):
    """Pickle ``obj.state_dict()`` to ``custom_checkpoint_<index>.bin``
    (one process writes: ``save_on_each_node`` changes nothing)."""
    location = os.path.join(path, CUSTOM_STATE_PATTERN.format(index) + ".bin")
    logger.info("Saving the state of %s to %s", type(obj).__name__, location)
    _pickle(obj.state_dict(), location)


def load_custom_state(obj, path: str, index: int = 0):
    location = os.path.join(path, CUSTOM_STATE_PATTERN.format(index) + ".bin")
    logger.info("Loading the state of %s from %s", type(obj).__name__, location)
    obj.load_state_dict(_unpickle(location))


def save_model_weights(model, save_directory: str, max_shard_size="10GB",
                       safe_serialization: bool = True):
    """Export a model's weights to ``save_directory`` as the reference's
    ``save_model`` does: ``model.safetensors`` under ``params/`` (a port
    model's in the reference's names and layout, each leaf
    in its own dtype; a ResNet's BatchNorm statistics under
    ``batch_stats/``), sharded as ``model-0000i-of-0000n.safetensors``
    with ``model.safetensors.index.json`` past ``max_shard_size``; or one
    pickle of numpy arrays, ``model.msgpack``, with
    ``safe_serialization=False`` (the reference's name for it)."""
    if os.path.isfile(save_directory):
        logger.error("Provided path (%s) should be a directory, not a file", save_directory)
        return None
    os.makedirs(save_directory, exist_ok=True)
    entries = _model_entries(model, buffer_prefix="")
    if safe_serialization:
        return save_entries(entries, os.path.join(save_directory, SAFE_WEIGHTS_NAME),
                            _parse_size(max_shard_size))
    return save_pytree(materialize_entries(entries), os.path.join(save_directory, WEIGHTS_NAME),
                       safe_serialization=False)


def _parse_size(size) -> int:
    """``"10GB"``, ``"200KB"``, ``"1.5MB"`` or bytes -> bytes (powers of 1024)."""
    if isinstance(size, int):
        return size
    size = str(size).upper().strip()
    for suffix, mult in (("GB", 1024**3), ("MB", 1024**2), ("KB", 1024)):
        if size.endswith(suffix):
            return int(float(size[: -len(suffix)]) * mult)
    return int(size)


def _find(folder: str, stem: str) -> Optional[str]:
    """``stem``'s sharded index, safetensors file or pickle in ``folder``;
    the bare stem for the reference's per-rank manifests, on which
    ``load_flat_dict`` raises (reading them is a later slice)."""
    base = os.path.join(folder, stem)
    if glob.glob(f"{glob.escape(base)}.rank*.manifest.json"):
        return base
    for ext in (".safetensors.index.json", ".safetensors", ".bin"):
        if os.path.exists(base + ext):
            return base + ext
    return None
