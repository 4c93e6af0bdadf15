"""Checkpoints of a sharded run, both ways with the JAX reference, on the
CPU.

The port's FSDP run on two gloo ranks (the ``tiny`` decoder, fp32, SGD
with momentum 0.9, one ``build_train_step`` update a batch) saves its
state as the reference's per-rank manifests (``model_0.rank<r>`` and
``optimizer_0.rank<r>``: each rank writes its share of the whole
weights and moments):

- the reference's ``_load_dist`` reads them: the weights equal the run's
  after its first update, bit for bit, and the momentum is optax.sgd's
  trace of that update;
- a fresh two-rank run resumed from them takes the second update bit for
  bit as the uninterrupted run took it (loss and every parameter);
- the reference's own run (its ``Accelerator`` on the 8 host devices with
  ``ShardingConfig(strategy="FSDP")``, whose ``save_state`` writes
  ``save_pytree_dist``'s manifests) resumes in a two-rank port run, whose
  next update matches the reference's (loss 1e-5 relative, parameters
  1e-5 of each leaf's largest entry).

SGD: its update is linear in the gradient, so a resumed update checks
the restored weights and momentum directly.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import optax
import torch

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import Model
from accelerate_tpu.models import DecoderConfig as JaxConfig
from accelerate_tpu.models import DecoderLM as JaxLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.utils import serialization as ref_serialization
from accelerate_tpu.utils.dataclasses import ShardingConfig as JaxSharding
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from torch_dist_workers import checkpoint_worker, gathered

SEQ, BATCH, LR, MOMENTUM = 64, 8, 0.5, 0.9
CONFIG = dict(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's run (init, an update, save_state, a second update),
    then the port's two-rank worker over the same weights and batches."""
    d = tmp_path_factory.mktemp("ckpt")
    batches = [np.random.RandomState(seed).randint(0, 256, (BATCH, SEQ)).astype(np.int32)
               for seed in (1, 2)]
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(sharding_config=JaxSharding(strategy="FSDP"))
    definition = JaxLM(JaxConfig.tiny(**CONFIG), mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(11), batch_size=BATCH,
                                          seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    model, _ = acc.prepare(Model(definition, variables), optax.sgd(LR, momentum=MOMENTUM))
    step = acc.build_train_step()
    step({"input_ids": batches[0], "labels": batches[0]})
    ref_dir = str(d / "reference")
    acc.save_state(ref_dir)
    second = float(step({"input_ids": batches[1], "labels": batches[1]})["loss"])
    ref_final = jax.tree_util.tree_map(np.asarray,
                                       unbox_params(acc.unwrap_model(model).params)[0])
    JaxState._reset_state(reset_partial_state=True)
    cfg = DecoderConfig.tiny(**CONFIG)
    weights = {k: v.numpy() for k, v in from_reference(p0, cfg, dtype=torch.float32).items()}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"config": CONFIG, "weights": weights, "batches": batches,
                     "sgd": {"lr": LR, "momentum": MOMENTUM},
                     "reference_dir": ref_dir}, f)
    debug_launcher(checkpoint_worker, (str(d),), num_processes=2, timeout=WORLD_TIMEOUT)
    return {"dir": str(d), "ranks": gathered(str(d), "ckpt", 2), "ref_dir": ref_dir,
            "ref_second": second, "ref_final": ref_final, "cfg": cfg}


def test_reference_wrote_rank_manifests(run):
    assert os.path.exists(os.path.join(run["ref_dir"], "model_0.rank0.manifest.json"))


def test_port_manifests_read_by_reference(run):
    r0 = run["ranks"][0]
    ckpt = os.path.join(run["dir"], "ckpt")
    files = sorted(os.listdir(ckpt))
    assert {"model_0.rank0.manifest.json", "model_0.rank1.manifest.json",
            "optimizer_0.rank0.manifest.json", "optimizer_0.rank1.manifest.json"} <= set(files)
    flat = ref_serialization._load_dist(os.path.join(ckpt, "model_0"))
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    got = from_reference(params, run["cfg"])
    assert set(got) == set(r0["saved"])
    for name, w in r0["saved"].items():
        assert np.array_equal(np.asarray(got[name]), w), name
    opt = ref_serialization._load_dist(os.path.join(ckpt, "optimizer_0"))
    trace = {k[len("0/trace/"):]: v for k, v in opt.items() if k.startswith("0/trace/")}
    momentum = from_reference(trace, run["cfg"])
    # after one update the trace is the first gradient: (w0 - w1) / lr
    w0 = {k: v for k, v in pickle.load(open(os.path.join(run["dir"], "inputs.pkl"), "rb"))
          ["weights"].items()}
    # (within the fp32 rounding of the weights' difference: a few ulps of
    # |w| over lr, beside 1e-5 of the trace)
    ulp = np.finfo(np.float32).eps
    for name, m in momentum.items():
        m = np.asarray(m)
        atol = 4 * ulp * np.abs(w0[name]).max() / LR + 1e-5 * np.abs(m).max()
        np.testing.assert_allclose(m, (w0[name] - r0["saved"][name]) / LR, atol=atol, rtol=0,
                                   err_msg=name)


def test_resume_is_bit_for_bit(run):
    for r, res in enumerate(run["ranks"]):
        assert res["resumed"] == res["second"], r
        for name, w in res["a"].items():
            assert np.array_equal(res["loaded"][name], res["saved"][name]), (r, name)
            assert np.array_equal(res["b"][name], w), (r, name)


def test_reference_checkpoint_resumes_in_the_port(run):
    for r, res in enumerate(run["ranks"]):
        np.testing.assert_allclose(res["from_reference"], run["ref_second"], rtol=1e-5)
        tree = to_reference({k: torch.from_numpy(v) for k, v in res["c"].items()}, run["cfg"])
        for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(run["ref_final"]),
                                     jax.tree_util.tree_leaves_with_path(tree)):
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                       err_msg=f"rank {r} {jax.tree_util.keystr(path)}")
