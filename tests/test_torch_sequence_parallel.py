"""Sequence parallelism: the decoder on a ``sequence`` axis (ring attention
over each rank's chunk, global positions, the labels shifted on the
global sequence, the loss over the global batch), on gloo ranks against
the JAX reference, on the CPU.

The model is the ``tiny`` decoder (2 layers, E 64, 4 heads over 2,
vocab 256, fp32, plain attention: the reference's ring runs its dense
hops, the port's the kernels' plain versions), its weights the
reference's init. The reference is the JAX ``Accelerator`` on a mesh of
the 8 host devices with a ``sequence`` axis of 2 (``data`` 4): the forward
loss, then one ``build_train_step`` update (its loss and grad norm) with
``optax.sgd``. The port runs ``{sequence: 2}`` (a world of 2: every
rank all 8 rows, half of the 64 positions) and ``{fsdp: 2, sequence:
2}`` (a world of 4), the forward and one SGD update of the eager loop,
each rank's batch from its prepared loader (``split_batches``: its rows
of the global batch and its chunk of the sequence).
SGD and not AdamW: SGD's update is linear in the gradient, so the
parameters after it check the reduced gradient's value and scale, where
AdamW's first update (lr * g / (|g| + eps)) is blind to the scale and
turns fp32 reduce-order noise in near-zero entries into lr-sized noise.

Tolerances: losses 1e-5 relative, the grad norm 1e-4 relative, every
parameter after the update 1e-5 of its largest entry.
"""

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
from accelerate_tpu.utils.dataclasses import ShardingConfig as JaxSharding
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from torch_dist_workers import gathered, sequence_worker

SEQ, BATCH = 64, 8
SGD = dict(lr=0.5)
CONFIG = dict(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
LAYOUTS = {"seq2": {"sequence_parallel": 2}, "fsdp2_seq2": {"strategy": "FSDP", "fsdp": 2,
                                                            "sequence_parallel": 2}}
WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(sharding_config=JaxSharding(data_parallel=4, sequence_parallel=2))
    jcfg = JaxConfig.tiny(**CONFIG)
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(5), batch_size=BATCH, seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    ids = np.random.RandomState(7).randint(0, 256, (BATCH, SEQ)).astype(np.int32)
    ids_labels = ids.copy()
    forward = float(definition.apply(variables, ids, labels=ids_labels)["loss"])
    model, _ = acc.prepare(Model(definition, variables), optax.sgd(SGD["lr"]))
    m = acc.build_train_step()({"input_ids": ids, "labels": ids})
    final = jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])
    shape = dict(acc.mesh.shape)
    JaxState._reset_state(reset_partial_state=True)
    cfg = DecoderConfig.tiny(**CONFIG)
    weights = {k: v.numpy() for k, v in from_reference(p0, cfg, dtype=torch.float32).items()}
    return {"ids": ids, "weights": weights, "forward": forward, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "final": final, "mesh": shape,
            "tmp": tmp_path_factory}


@pytest.fixture(scope="module", params=[("seq2", 2), ("fsdp2_seq2", 4)],
                ids=["seq2", "fsdp2_seq2"])
def world(request, reference):
    name, n = request.param
    d = reference["tmp"].mktemp(name)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"config": CONFIG, "weights": reference["weights"],
                     "batch": reference["ids"], "sgd": SGD, "layouts": LAYOUTS}, f)
    debug_launcher(sequence_worker, (str(d), name), num_processes=n, timeout=WORLD_TIMEOUT)
    return name, gathered(str(d), name, n)


def test_reference_mesh_has_a_sequence_axis(reference):
    assert reference["mesh"]["sequence"] == 2


def test_forward_and_update_match_reference(reference, world):
    name, ranks = world
    cfg = DecoderConfig.tiny(**CONFIG)
    for r, res in enumerate(ranks):
        assert res["mesh"]["sequence"] == 2
        np.testing.assert_allclose(res["forward"], reference["forward"], rtol=1e-5)
        np.testing.assert_allclose(res["loss"], reference["loss"], rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"], reference["grad_norm"], rtol=1e-4)
        tree = to_reference({k: torch.from_numpy(v) for k, v in res["params"].items()}, cfg)
        for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(reference["final"]),
                                     jax.tree_util.tree_leaves_with_path(tree)):
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(g), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                       err_msg=f"{name} rank {r} {jax.tree_util.keystr(path)}")
