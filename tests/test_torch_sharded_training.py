"""Sharded training (``parallel/sharding.py`` on FSDP2, the Accelerator's
reduce, clip and fp16 agreement) on gloo ranks against the JAX
reference, on the CPU.

The model is the ``tiny`` decoder (2 layers, E 64, 4 heads over 2,
vocab 256, fp32, plain attention on both sides), its weights the
reference's init carried by ``models/convert.py``. The reference is the
JAX ``Accelerator``'s ``build_train_step`` with ``optax.sgd`` on its own
mesh: ``ShardingConfig(strategy="FSDP")`` over the 8 host devices (fsdp
8), which computes the update of the global batch whatever the layout.
The port runs DP 2, FSDP 2, GRAD_OP 2 (one world of 2, spawned once),
FSDP 4 and HYBRID 2 x 2 (one world of 4), each rank feeding its rows of
the same global batch of 8 x 64, with ``min_weight_size_to_shard`` 1024 so
every matrix (15 of the 20 parameters) is sharded (the norms stay
replicated).

Tolerances: loss 1e-5 relative, grad norm 1e-4 relative, every parameter
after the update 1e-5 relative to its largest entry (fp32; the ranks'
gradient shards and the loss's sum and count are reduced in another
order than XLA's). The eager window of two micro-batches under
``no_sync`` with ``clip_grad_norm_`` is held against the port's own
unsharded window in this process (1e-6 relative), and makes one
all-reduce of the replicated gradients. fp16: a non-finite
gradient shard on one rank only skips the update on every rank.

The bidirectional families take a mesh too: BERT's classifier and T5 on
DP 2, FSDP 2 and ``{sequence: 2}`` (where each rank's chunks are gathered
into the whole sequence, as the reference's attention there is not a
ring), one SGD update each from the reference's init. Each is held against
the reference Accelerator's ``build_train_step`` with ``optax.sgd`` on a
mesh of the same layout over the 8 host devices (data 8; fsdp 2 x data 4;
sequence 2 x data 4), with the decoder's tolerances, and against the
port's unsharded update in this process (loss 1e-5 relative, grad norm
1e-5 relative, parameters 1e-6 of each leaf's largest entry).
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
from accelerate_tpu.models import EncoderClassifier as JaxClassifier
from accelerate_tpu.models import EncoderConfig as JaxEncoderConfig
from accelerate_tpu.models import Seq2SeqConfig as JaxSeq2SeqConfig
from accelerate_tpu.models import Seq2SeqLM as JaxSeq2SeqLM
from accelerate_tpu.parallel.sharding import unbox_params
from accelerate_tpu.state import AcceleratorState as JaxState
from accelerate_tpu.utils.dataclasses import ShardingConfig as JaxSharding
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.models.configs import DecoderConfig
from accelerate_tpu_torch.models.convert import from_reference, to_reference
from accelerate_tpu_torch.models.decoder import DecoderLM
from torch_dist_workers import (family_model, family_step, family_worker, fp16_skip_worker,
                                gathered, train_worker)

SEQ, BATCH, LR, CLIP, MICRO = 64, 8, 0.5, 0.05, 2
# plain SGD: the update is linear in the reduced gradient, so the
# parameters after it check the gradient's value and scale (Adam's first
# update, lr * g / (|g| + eps), is blind to a gradient's scale and turns
# the ranks' reduce-order noise in near-zero entries into lr-sized noise)
SGD = dict(lr=LR)
CONFIG = dict(num_kv_heads=2, max_seq_len=SEQ, attention_impl="xla")
LAYOUTS = {
    "w2": {"dp2": {"layout": {"strategy": "DP", "data_parallel": 2}, "mode": "fused"},
           "fsdp2": {"layout": {"strategy": "FSDP", "fsdp": 2}, "mode": "fused"},
           "grad_op2": {"layout": {"strategy": "GRAD_OP", "fsdp": 2}, "mode": "fused"},
           "fsdp2_clip": {"layout": {"strategy": "FSDP", "fsdp": 2}, "mode": "fused",
                          "clip": True},
           "dp2_window": {"layout": {"strategy": "DP", "data_parallel": 2}, "mode": "eager"},
           "fsdp2_window": {"layout": {"strategy": "FSDP", "fsdp": 2}, "mode": "eager"}},
    "w4": {"fsdp4": {"layout": {"strategy": "FSDP", "fsdp": 4}, "mode": "fused"},
           "hybrid": {"layout": {"strategy": "HYBRID", "replica": 2, "fsdp": 2},
                      "mode": "fused"}},
}
WORLD_TIMEOUT = 240


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's initial weights, the global batch and its update
    (unclipped, and clipped at CLIP)."""
    jcfg = JaxConfig.tiny(**CONFIG)
    ids = np.random.RandomState(25).randint(0, 256, (BATCH, SEQ)).astype(np.int32)
    out = {}
    for clip in (None, CLIP):
        JaxState._reset_state(reset_partial_state=True)
        acc = JaxAccelerator(sharding_config=JaxSharding(strategy="FSDP"))
        definition = JaxLM(jcfg, mesh=acc.mesh)
        variables = definition.init_variables(jax.random.PRNGKey(3), batch_size=BATCH,
                                              seq_len=SEQ)
        p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
        model, opt = acc.prepare(Model(definition, variables), optax.sgd(LR))
        if clip is not None:
            acc.clip_grad_norm_(max_norm=clip)
        step = acc.build_train_step()
        m = step({"input_ids": ids, "labels": ids})
        final = jax.tree_util.tree_map(np.asarray,
                                       unbox_params(acc.unwrap_model(model).params)[0])
        out[clip] = (float(m["loss"]), float(m["grad_norm"]), final, acc.mesh.shape)
        JaxState._reset_state(reset_partial_state=True)
    cfg = DecoderConfig.tiny(**CONFIG)
    weights = {k: v.numpy() for k, v in from_reference(p0, cfg, dtype=torch.float32).items()}
    return {"ids": ids, "weights": weights, "p0": p0, "reference": out,
            "tmp": tmp_path_factory}


def _spawn(setup, name, n, worker=train_worker, args=None):
    d = setup["tmp"].mktemp(name)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"config": CONFIG, "weights": setup["weights"], "batch": setup["ids"],
                     "sgd": SGD, "clip": CLIP, "micro": MICRO, "layouts": LAYOUTS}, f)
    debug_launcher(worker, (str(d),) + (args or ()), num_processes=n, timeout=WORLD_TIMEOUT)
    return str(d)


@pytest.fixture(scope="module")
def world2(setup):
    return gathered(_spawn(setup, "w2", 2, args=("w2",)), "w2", 2)


@pytest.fixture(scope="module")
def world4(setup):
    return gathered(_spawn(setup, "w4", 4, args=("w4",)), "w4", 4)


def _check_params(got: dict, want_tree, what: str, cfg=None):
    cfg = cfg or DecoderConfig.tiny(**CONFIG)
    tree = to_reference({k: torch.from_numpy(v) for k, v in got.items()}, cfg)
    want_leaves = jax.tree_util.tree_leaves_with_path(want_tree)
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves], what
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("world,key,strategy,shape", [
    ("world2", "dp2", "DP", {"data": 2}),
    ("world2", "fsdp2", "FSDP", {"fsdp": 2}),
    ("world2", "grad_op2", "GRAD_OP", {"fsdp": 2}),
    ("world4", "fsdp4", "FSDP", {"fsdp": 4}),
    ("world4", "hybrid", "HYBRID", {"replica": 2, "fsdp": 2}),
])
def test_one_update_matches_reference(request, setup, world, key, strategy, shape):
    ranks = request.getfixturevalue(world)
    loss, norm, final, _ = setup["reference"][None]
    for r, res in enumerate(ranks):
        got = res[key]
        assert got["strategy"] == strategy
        assert {a: s for a, s in got["mesh"].items() if s > 1} == shape
        assert got["sharded"] == (0 if strategy == "DP" else 15), got["sharded"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
        _check_params(got["params"], final, f"{key} rank {r}")
    for name in ranks[0][key]["params"]:  # the ranks agree exactly
        assert all(np.array_equal(res[key]["params"][name], ranks[0][key]["params"][name])
                   for res in ranks)


def test_clipped_update_matches_reference(setup, world2):
    loss, norm, final, _ = setup["reference"][CLIP]
    assert norm > CLIP  # the clip acts
    for r, res in enumerate(world2):
        got = res["fsdp2_clip"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
        _check_params(got["params"], final, f"clipped rank {r}")


def _unsharded_window(setup) -> dict:
    """The port's eager window on one process: MICRO micro-batches of the
    global batch, clip_grad_norm_ at CLIP, one SGD step."""
    cfg = DecoderConfig.tiny(**CONFIG)
    acc = Accelerator(cpu=True)
    model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32).load_params(
        {k: torch.from_numpy(v) for k, v in setup["weights"].items()})
    opt = torch.optim.SGD(model.parameters(), **SGD)
    model, opt = acc.prepare(model, opt)
    ids = torch.from_numpy(setup["ids"])
    losses = []
    for mb in ids.chunk(MICRO):
        loss = model(input_ids=mb, labels=mb)["loss"]
        acc.backward(loss / MICRO)
        losses.append(loss.item())
    norm = acc.clip_grad_norm_(max_norm=CLIP).item()
    opt.step()
    return {"loss": float(np.mean(losses)), "grad_norm": norm,
            "params": {k: v.detach().numpy() for k, v in model.named_parameters()}}


@pytest.mark.parametrize("key", ["dp2_window", "fsdp2_window"])
def test_no_sync_window_with_clip_equals_unsharded(setup, world2, key):
    """Two micro-batches a rank, the first under no_sync (FSDP2 reduces
    nothing there), the global clip over every shard: the unsharded
    window's update. The window's micro-batches are each rank's halves, so
    the global batch's micro-batch split differs from the unsharded one:
    the loss is compared as the mean of the ranks' micro-batch losses."""
    want = _unsharded_window(setup)
    assert want["grad_norm"] > CLIP
    losses = [res[key]["loss"] for res in world2]
    np.testing.assert_allclose(np.mean(losses), want["loss"], rtol=1e-5)
    for r, res in enumerate(world2):
        got = res[key]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, atol=1e-6 * np.abs(w).max(),
                                       rtol=0, err_msg=f"{key} rank {r} {name}")


@pytest.mark.parametrize("key", ["dp2_window", "fsdp2_window"])
def test_eager_window_reduces_replicated_gradients_once(setup, world2, key):
    """backward, clip_grad_norm_, step: the replicated gradients are
    all-reduced once in the window (by the clip, for the global norm; the
    update does not reduce them again), in one all-reduce of their
    concatenation (every gradient under DP); the other all-reduces are the
    norms' scalars (FSDP's sharded squares, once for the clip's norm and
    once for the update's clip)."""
    total = sum(w.size for w in setup["weights"].values())
    for res in world2:
        sizes = res[key]["all_reduces"]
        vectors = [n for n in sizes if n > 1]
        assert len(vectors) == 1, sizes
        if key == "dp2_window":
            assert sizes == [total]
        else:
            assert vectors[0] < total and sizes.count(1) == 2, sizes


def test_fp16_overflow_on_one_rank_skips_everywhere(setup):
    d = _spawn(setup, "fp16", 2, worker=fp16_skip_worker)
    ranks = gathered(d, "fp16", 2)
    assert all(r["skipped"] and r["unchanged"] for r in ranks), ranks
    assert {r["scale"] for r in ranks} == {512.0}  # 1024 backed off once, on both


FAMILIES = {"encoder": dict(dropout_rate=0.0, max_seq_len=32),
            "seq2seq": dict(dropout_rate=0.0)}
FAMILY_LAYOUTS = {"dp2": {"strategy": "DP", "data_parallel": 2},
                  "fsdp2": {"strategy": "FSDP", "fsdp": 2},
                  "seq2": {"sequence_parallel": 2}}
# the reference's mesh of each layout over the 8 host devices (data fills the rest)
REFERENCE_FAMILY_LAYOUTS = {"dp2": {"strategy": "DP"},
                            "fsdp2": {"strategy": "FSDP", "fsdp": 2},
                            "seq2": {"sequence_parallel": 2}}
SRC, TGT = 32, 16


def _family_batch(family: str) -> dict:
    rng = np.random.RandomState(31)
    ids = rng.randint(3, 256, (BATCH, SRC)).astype(np.int64)
    mask = np.ones((BATCH, SRC), np.int64)
    mask[1, 20:] = 0
    if family == "encoder":
        return {"input_ids": ids, "attention_mask": mask,
                "labels": rng.randint(0, 2, (BATCH,)).astype(np.int64)}
    return {"input_ids": ids, "attention_mask": mask,
            "labels": rng.randint(3, 256, (BATCH, TGT)).astype(np.int64)}


def _port_family_config(family: str):
    from accelerate_tpu_torch.models.configs import EncoderConfig
    from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig

    return (EncoderConfig if family == "encoder" else Seq2SeqConfig).tiny(**FAMILIES[family])


def _reference_family(family: str, batch: dict):
    """The reference's init of ``family`` and its SGD update of ``batch``
    on each layout's mesh: {layout: (loss, grad norm, params after, mesh)}."""
    if family == "encoder":
        cls, cfg = JaxClassifier, JaxEncoderConfig.tiny(**FAMILIES[family])
        variables = cls(cfg).init_variables(jax.random.PRNGKey(4), batch_size=2, seq_len=SRC)
    else:
        cls, cfg = JaxSeq2SeqLM, JaxSeq2SeqConfig.tiny(**FAMILIES[family])
        variables = cls(cfg).init_variables(jax.random.PRNGKey(4), batch_size=2, seq_len=SRC,
                                            target_len=TGT)
    p0 = jax.tree_util.tree_map(np.asarray, unbox_params(variables["params"])[0])
    jbatch = {k: v.astype(np.int32) for k, v in batch.items()}
    out = {}
    for layout, spec in REFERENCE_FAMILY_LAYOUTS.items():
        JaxState._reset_state(reset_partial_state=True)
        acc = JaxAccelerator(sharding_config=JaxSharding(**spec))
        model, _ = acc.prepare(Model(cls(cfg, mesh=acc.mesh), {"params": p0}), optax.sgd(LR))
        m = acc.build_train_step()(jbatch)
        final = jax.tree_util.tree_map(np.asarray,
                                       unbox_params(acc.unwrap_model(model).params)[0])
        out[layout] = (float(m["loss"]), float(m["grad_norm"]), final, dict(acc.mesh.shape))
    JaxState._reset_state(reset_partial_state=True)
    return p0, out


@pytest.fixture(scope="module")
def families(setup):
    cases, reference = {}, {}
    for family in FAMILIES:
        batch = _family_batch(family)
        p0, reference[family] = _reference_family(family, batch)
        weights = {k: v.numpy() for k, v in from_reference(
            p0, _port_family_config(family), dtype=torch.float32).items()}
        for layout, spec in FAMILY_LAYOUTS.items():
            cases[f"{family}-{layout}"] = {"family": family, "config": FAMILIES[family],
                                           "weights": weights, "layout": spec,
                                           "batch": batch}
    d = setup["tmp"].mktemp("families")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"cases": cases, "lr": LR}, f)
    debug_launcher(family_worker, (str(d),), num_processes=2, timeout=WORLD_TIMEOUT)
    return cases, reference, gathered(str(d), "family", 2)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("layout", list(FAMILY_LAYOUTS))
def test_bidirectional_families_match_reference_on_a_mesh(families, family, layout):
    cases, reference, ranks = families
    loss, norm, final, mesh = reference[family][layout]
    axis = {"dp2": "data", "fsdp2": "fsdp", "seq2": "sequence"}[layout]
    assert mesh[axis] > 1, mesh
    for r, res in enumerate(ranks):
        got = res[f"{family}-{layout}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
        _check_params(got["params"], final, f"{family} {layout} rank {r}",
                      cfg=_port_family_config(family))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("layout", list(FAMILY_LAYOUTS))
def test_bidirectional_families_train_on_a_mesh(families, family, layout):
    cases, _, ranks = families
    case = cases[f"{family}-{layout}"]
    model = family_model(family, case["config"], case["weights"])
    want = family_step(Accelerator(cpu=True), model,
                       {k: torch.from_numpy(v) for k, v in case["batch"].items()}, LR)
    for r, res in enumerate(ranks):
        got = res[f"{family}-{layout}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name], w, atol=1e-6 * np.abs(w).max(),
                                       rtol=0, err_msg=f"{family} {layout} rank {r} {name}")
