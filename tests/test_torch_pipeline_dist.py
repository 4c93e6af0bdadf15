"""Pipeline parallelism over the ``stage`` axis on gloo ranks, against the
JAX reference, on the CPU.

The model is the ``tiny`` decoder at 4 layers (E 64, 4 heads over 2,
vocab 256, fp32, plain attention on both sides) in 4 strided
microbatches, its weights the reference's pipelined init carried by
``models/convert.py`` (``pipeline/schedule/stages/layers/...``, leaves
[S, L / S, ...]). The reference is the JAX ``Accelerator``'s
``build_train_step`` with ``optax.sgd`` on its own stage mesh over the 8
host devices (``stage 2 x data 4``; a global batch of 16 x 32, so each
microbatch's 4 rows divide over its data axis), once per schedule, and
once more for 1F1B with ``clip_grad_norm_``. The port runs ``stage 2``
(a world of 2, spawned once) and ``stage 2 x data 2`` and ``stage 2 x
fsdp 2`` (a world of 4), each rank building only its stage's two blocks
and feeding its rows of the same global batch. Tolerances are those of
``tests/test_torch_sharded_training.py``:
loss 1e-5 relative, grad norm 1e-4 relative, each parameter after the
update 1e-5 of its leaf's largest entry (fp32; the ranks' gradients and
the loss's sum and count are reduced in another order than XLA's).

A prepared loader gives the ranks of one stage group the same rows (its
batch axes are the data axes only). After the checkpoint run, world 2
folds its stages back with ``depipeline`` (every rank gathers every
block) and splits them again with ``prepare_pippy`` (the stage count
from the mesh): both give the logits of an unpipelined model on the
reference's updated weights, within 1e-5, on every rank.

Checkpoints go both ways: the reference's pipelined ``save_state`` (its
per-rank manifests) resumes in the port's world of 2, and that world's
``save_state`` resumes in the reference's pipelined ``load_state``.
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
from accelerate_tpu_torch.models.convert import from_reference, reference_leaves, to_reference
from torch_dist_workers import gathered, pipeline_worker

SEQ, BATCH, LR, CLIP, M = 32, 16, 0.5, 0.05, 4
SGD = dict(lr=LR)
CONFIG = dict(num_layers=4, num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
REF_MESH = dict(pipeline_parallel=2, data_parallel=4)
GPIPE = {"pipeline_microbatches": M, "pipeline_schedule": "gpipe"}
ONE_F = {"pipeline_microbatches": M, "pipeline_schedule": "1f1b"}
STAGE2 = {"strategy": "DP", "pipeline_parallel": 2}
DATA = {"strategy": "DP", "pipeline_parallel": 2, "data_parallel": 2}
FSDP = {"strategy": "FSDP", "pipeline_parallel": 2, "fsdp": 2}
LAYOUTS = {
    "w2": {"gpipe": {"layout": STAGE2, "pipeline": GPIPE},
           "1f1b": {"layout": STAGE2, "pipeline": ONE_F},
           "1f1b_clip": {"layout": STAGE2, "pipeline": ONE_F, "clip": True}},
    "w4": {"data_gpipe": {"layout": DATA, "pipeline": GPIPE},
           "data_1f1b": {"layout": DATA, "pipeline": ONE_F},
           "fsdp_gpipe": {"layout": FSDP, "pipeline": GPIPE},
           "fsdp_1f1b_clip": {"layout": FSDP, "pipeline": ONE_F, "clip": True}},
}
# which reference run each layout is held against
REFERENCE_OF = {"gpipe": "gpipe", "1f1b": "1f1b", "1f1b_clip": "1f1b_clip",
                "data_gpipe": "gpipe", "data_1f1b": "1f1b", "fsdp_gpipe": "gpipe",
                "fsdp_1f1b_clip": "1f1b_clip"}
WORLD_TIMEOUT = 240


def _reference(sched: str, clip, ids, ckpt=None):
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(sharding_config=JaxSharding(**REF_MESH))
    jcfg = JaxConfig.tiny(**CONFIG, pipeline_microbatches=M, pipeline_schedule=sched)
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(3), batch_size=BATCH, seq_len=SEQ)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    model, _ = acc.prepare(Model(definition, variables), optax.sgd(LR))
    if clip is not None:
        acc.clip_grad_norm_(max_norm=clip)
    m = acc.build_train_step()({"input_ids": ids, "labels": ids})
    final = jax.tree_util.tree_map(np.asarray, unbox_params(acc.unwrap_model(model).params)[0])
    if ckpt is not None:
        acc.save_state(ckpt)
    JaxState._reset_state(reset_partial_state=True)
    return p0, (float(m["loss"]), float(m["grad_norm"]), final)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's pipelined initial weights, the global batch, its
    updates, and its checkpoint after the GPipe update."""
    ids = np.random.RandomState(26).randint(0, 256, (BATCH, SEQ)).astype(np.int32)
    ref_dir = str(tmp_path_factory.mktemp("reference_ckpt"))
    out = {}
    p0, out["gpipe"] = _reference("gpipe", None, ids, ckpt=ref_dir)
    _, out["1f1b"] = _reference("1f1b", None, ids)
    _, out["1f1b_clip"] = _reference("1f1b", CLIP, ids)
    cfg = DecoderConfig.tiny(**CONFIG)
    weights = {k: v.numpy() for k, v in from_reference(p0, cfg, dtype=torch.float32).items()}
    return {"ids": ids, "weights": weights, "reference": out, "reference_dir": ref_dir,
            "tmp": tmp_path_factory}


def _spawn(setup, name, n):
    d = setup["tmp"].mktemp(name)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"config": CONFIG, "weights": setup["weights"], "batch": setup["ids"],
                     "sgd": SGD, "clip": CLIP, "pipeline": LAYOUTS,
                     "checkpoint": {"w2": {"layout": STAGE2, "pipeline": GPIPE}},
                     "reference_dir": setup["reference_dir"]}, f)
    debug_launcher(pipeline_worker, (str(d), name), num_processes=n, timeout=WORLD_TIMEOUT)
    return str(d), gathered(str(d), name, n)


@pytest.fixture(scope="module")
def world2(setup):
    return _spawn(setup, "w2", 2)


@pytest.fixture(scope="module")
def world4(setup):
    return _spawn(setup, "w4", 4)


def _merged(ranks: list, key: str) -> dict:
    """Every rank's parameters of layout ``key`` in one dict: each block
    from the rank that holds it, the replicated ones equal on all."""
    out = {}
    for r in ranks:
        for k, v in r[key]["params"].items():
            if k in out and not k.startswith("layers."):
                np.testing.assert_array_equal(out[k], v, err_msg=f"{key}: {k} differs by rank")
            out[k] = v
    return out


def _check_params(got: dict, want_tree, what: str):
    cfg = DecoderConfig.tiny(**CONFIG, pipeline_stages=2)
    tree = reference_leaves(to_reference({k: torch.from_numpy(v) for k, v in got.items()}, cfg))
    want = reference_leaves(want_tree)
    assert sorted(tree) == sorted(want), what
    for k, w in want.items():
        err = np.abs(tree[k] - np.asarray(w)).max() / (np.abs(np.asarray(w)).max() + 1e-12)
        assert err < 1e-5, (what, k, err)


def _check(setup, ranks, key):
    loss, norm, final = setup["reference"][REFERENCE_OF[key]]
    for r in ranks:
        got = r[key]
        # 1F1B layouts trained through the schedule's value-and-grad
        assert got["one_f_one_b"] == ("1f1b" in key), key
        # FSDP sharded the blocks' and the embedding's matrices
        assert (got["sharded"] > 0) == ("fsdp" in key), key
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4, err_msg=key)
    _check_params(_merged(ranks, key), final, key)


@pytest.mark.parametrize("key", list(LAYOUTS["w2"]))
def test_world2_update_matches_reference(setup, world2, key):
    _check(setup, world2[1], key)


@pytest.mark.parametrize("key", list(LAYOUTS["w4"]))
def test_world4_update_matches_reference(setup, world4, key):
    _check(setup, world4[1], key)


def test_clip_counts_replicated_parameters_once(setup):
    """The clipped reference update differs from the unclipped one (the
    clip binds), so the clipped layouts' agreement with it shows the norm
    they clipped by is the reference's: the replicated parameters
    (embedding, final norm) counted once, not once per stage."""
    _, norm, _ = setup["reference"]["1f1b"]
    _, clipped_norm, clipped = setup["reference"]["1f1b_clip"]
    assert norm > CLIP
    _, _, unclipped = setup["reference"]["1f1b"]
    a, b = reference_leaves(clipped), reference_leaves(unclipped)
    assert max(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max() for k in a) > 1e-3


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_each_rank_holds_only_its_stage(setup, world2, world4, world):
    """Each rank built and holds only its stage's two blocks (and the
    replicated embedding and final norm): the parameter counts add up to
    the model once per data rank."""
    ranks = (world2 if world == "w2" else world4)[1]
    cfg = DecoderConfig.tiny(**CONFIG)
    per_layer = (cfg.num_params - cfg.vocab_size * cfg.embed_dim - cfg.embed_dim) // 4
    rest = cfg.num_params - 4 * per_layer
    for r in ranks:
        for key, res in r.items():
            if key not in LAYOUTS[world]:
                continue
            stage = res["mesh"].get("stage", 1)
            assert len(res["held"]) == 4 // stage, key
            if "fsdp" not in key:
                assert res["numel"] == rest + len(res["held"]) * per_layer, key
            assert all(k.split(".")[1] in {str(i) for i in res["held"]}
                       for k in res["params"] if k.startswith("layers.")), key
    held = sorted(tuple(r["gpipe" if world == "w2" else "data_gpipe"]["held"]) for r in ranks)
    assert held[0] == (0, 1) and held[-1] == (2, 3)


def test_reference_checkpoint_resumes_in_port(setup, world2):
    """The reference's pipelined per-rank checkpoint loads into the port's
    stage-2 world: every rank's parameters equal the reference's after its
    update, bit for bit."""
    _, _, final = setup["reference"]["gpipe"]
    merged = {}
    for r in world2[1]:
        merged.update(r["loaded"])
    cfg = DecoderConfig.tiny(**CONFIG, pipeline_stages=2)
    tree = reference_leaves(to_reference({k: torch.from_numpy(v) for k, v in merged.items()},
                                         cfg))
    for k, w in reference_leaves(final).items():
        np.testing.assert_array_equal(tree[k], np.asarray(w), err_msg=k)


def test_port_checkpoint_resumes_in_reference(setup, world2):
    """The port world's ``save_state`` (per-rank manifests, the reference's
    pipelined tree) loads into the reference's pipelined Accelerator."""
    import os

    d = os.path.join(world2[0], "ckpt")
    JaxState._reset_state(reset_partial_state=True)
    acc = JaxAccelerator(sharding_config=JaxSharding(**REF_MESH))
    jcfg = JaxConfig.tiny(**CONFIG, pipeline_microbatches=M)
    definition = JaxLM(jcfg, mesh=acc.mesh)
    variables = definition.init_variables(jax.random.PRNGKey(9), batch_size=BATCH, seq_len=SEQ)
    model, _ = acc.prepare(Model(definition, variables), optax.sgd(LR))
    acc.load_state(d)
    got = reference_leaves(jax.tree_util.tree_map(
        np.asarray, unbox_params(acc.unwrap_model(model).params)[0]))
    JaxState._reset_state(reset_partial_state=True)
    _, _, final = setup["reference"]["gpipe"]
    for k, w in reference_leaves(final).items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


@pytest.mark.parametrize("world", ["w2", "w4"])
def test_loader_gives_a_stage_group_the_same_rows(world2, world4, world):
    """Rank r sits at (stage, data) = divmod(r, D): the ranks of one data
    index get the same rows whatever their stage, and the D data indices
    together read each global batch of 8 D rows once."""
    ranks = (world2 if world == "w2" else world4)[1]
    d = 1 if world == "w2" else 2
    rows = [r["loader"] for r in ranks]
    for r in range(len(ranks)):
        assert rows[r] == rows[r % d], (world, r)
    assert len(rows[0]) == 32 // (8 * d)
    for i in range(len(rows[0])):
        got = sorted(x for data in range(d) for x in rows[data][i])
        assert got == list(range(8 * d * i, 8 * d * (i + 1))), (world, i)


def test_depipeline_and_prepare_pippy_on_the_stage_mesh(setup, world2):
    from accelerate_tpu_torch.models.decoder import DecoderLM

    _, _, final = setup["reference"]["gpipe"]
    cfg = DecoderConfig.tiny(**CONFIG)
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        from_reference(jax.tree_util.tree_map(np.asarray, final), cfg, dtype=torch.float32))
    ids = torch.from_numpy(setup["ids"][:4]).long()
    with torch.no_grad():
        want = model(ids).numpy()
    layers = sum(1 for _ in model.layers.parameters())
    held = []
    for r in world2[1]:
        np.testing.assert_allclose(r["depipelined"]["logits"], want, rtol=1e-5, atol=1e-5)
        assert r["depipelined"]["layers"] == layers  # every block, on every rank
        np.testing.assert_allclose(r["pippy"]["logits"], want[:3], rtol=1e-5, atol=1e-5)
        held.append(r["pippy"]["held"])
    assert held == [[0, 1], [2, 3]]
