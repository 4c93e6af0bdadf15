"""Worker functions of the multi-process CPU tests (``test_torch_ring``,
``test_torch_sequence_parallel``, ``test_torch_sharded_training``,
``test_torch_distributed_ops``, ``test_torch_sharded_checkpointing``).

Each runs in a process that ``launchers.debug_launcher`` spawned (gloo
over loopback); it reads its inputs from ``<dir>/inputs.pkl``, which the
test wrote, and writes ``<dir>/<name>.rank<r>.pkl`` for the test to hold
against the JAX reference. This module imports neither JAX nor the JAX
package, so a spawned worker starts with torch alone.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

MESH_AXES = ("replica", "stage", "data", "fsdp", "expert", "sequence", "tensor")


def read(d: str, name: str = "inputs"):
    with open(os.path.join(d, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def write(d: str, name: str, obj):
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    with open(os.path.join(d, f"{name}.rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def gathered(d: str, name: str, n: int) -> list:
    """What ``write`` left from each of ``n`` ranks (in the test)."""
    return [read(d, f"{name}.rank{r}") for r in range(n)]


def _mesh(axes: dict):
    from accelerate_tpu_torch.parallel.mesh import build_mesh

    return build_mesh({a: axes.get(a, 1) for a in MESH_AXES}, "cpu")


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def ring_worker(d: str):
    """Every case of ``inputs["cases"]``: this rank's chunk of (q, k, v,
    do) through ``ring_attention_sharded`` on a {sequence: n} mesh, forward
    and backward."""
    import torch.distributed as dist

    from accelerate_tpu_torch.parallel.context import ring_attention_sharded
    from accelerate_tpu_torch.state import PartialState

    PartialState(cpu=True)
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = _mesh({"sequence": n})
    out = {}
    for key, case in read(d)["cases"].items():
        q, k, v, do = (torch.from_numpy(case[x]) for x in ("q", "k", "v", "do"))
        s = q.shape[2] // n
        ql, kl, vl = (t[:, :, r * s:(r + 1) * s].clone().requires_grad_() for t in (q, k, v))
        o = ring_attention_sharded(ql, kl, vl, mesh, causal=case["causal"], impl="flash")
        o.backward(do[:, :, r * s:(r + 1) * s])
        out[key] = {"out": o.detach(), "dq": ql.grad, "dk": kl.grad, "dv": vl.grad}
    write(d, "ring", out)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _model(inputs, mesh=None):
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.decoder import DecoderLM

    cfg = DecoderConfig.tiny(**inputs["config"])
    return DecoderLM(cfg, device="cpu", param_dtype=torch.float32, mesh=mesh).load_params(
        {k: torch.from_numpy(v) for k, v in inputs["weights"].items()})


def _full(model) -> dict:
    from torch.distributed.tensor import DTensor

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().clone()
            for n, p in model.named_parameters()}


def _sharding(layout: dict):
    from accelerate_tpu_torch.utils.dataclasses import ShardingConfig

    kw = dict(layout)
    kw.setdefault("data_parallel", 1)
    return ShardingConfig(min_weight_size_to_shard=1024, **kw)


def _local_rows(mesh, batch: np.ndarray) -> torch.Tensor:
    """This rank's rows of the global batch (its data-axes shard) and, on a
    sequence axis, its chunk of dim 1: what its prepared loader gives it."""
    from accelerate_tpu_torch.parallel.mesh import axis_index

    i, n = axis_index(mesh, ("replica", "data", "fsdp"))
    c, m = axis_index(mesh, ("sequence",))
    rows = batch.shape[0] // n
    width = batch.shape[1] // m
    return torch.from_numpy(batch[i * rows:(i + 1) * rows, c * width:(c + 1) * width].copy())


def train_worker(d: str, name: str):
    """Each layout of ``inputs["layouts"][name]`` in turn, on this world:
    one ``build_train_step`` update of the global batch (``"fused"``), or
    the eager loop's window of ``inputs["micro"]`` micro-batches under
    ``no_sync`` with ``clip_grad_norm_`` (``"eager"``, which also records
    the sizes of the all-reduces that the clip and the update make); writes
    the loss, the grad norm, the parameters after and what the strategy
    did."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch import Accelerator

    inputs = read(d)
    results = {}
    for key, spec in inputs["layouts"][name].items():
        acc = Accelerator(cpu=True, sharding_config=_sharding(spec["layout"]))
        model = _model(inputs)
        opt = torch.optim.SGD(model.parameters(), **inputs["sgd"])
        model, opt = acc.prepare(model, opt)
        batch = inputs["batch"]
        if spec.get("clip"):
            acc.clip_grad_norm_(max_norm=inputs["clip"])
        res = {"strategy": str(acc.sharding_strategy),
               "sharded": sum(isinstance(p, DTensor) for p in model.parameters()),
               "mesh": acc.state.mesh_shape}
        if spec["mode"] == "fused":
            step = acc.build_train_step(micro_steps=spec.get("micro", 1))
            local = _local_rows(acc.mesh, batch)
            m = step({"input_ids": local, "labels": local})
            res.update(loss=m["loss"].item(), grad_norm=m["grad_norm"].item())
        else:
            local = _local_rows(acc.mesh, batch)
            micro = inputs["micro"]
            parts = local.chunk(micro)
            losses = []
            for i, mb in enumerate(parts):
                ctx = acc.no_sync(model) if i < micro - 1 else _nullcontext()
                with ctx:
                    loss = model(input_ids=mb, labels=mb)["loss"]
                    acc.backward(loss / micro * acc.gradient_state.num_steps)
                losses.append(loss.item())
            real, calls = dist.all_reduce, []

            def counting(*args, **kwargs):
                calls.append(args[0].numel())
                return real(*args, **kwargs)

            dist.all_reduce = counting  # the clip and the update's all-reduces
            try:
                res["grad_norm"] = acc.clip_grad_norm_(max_norm=inputs["clip"]).item()
                opt.step()
            finally:
                dist.all_reduce = real
            res["all_reduces"] = calls
            res["loss"] = float(np.mean(losses))
        res["params"] = {k: v.numpy() for k, v in _full(model).items()}
        results[key] = res
        acc.free_memory()
    write(d, name, results)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def fp16_skip_worker(d: str):
    """FSDP on two ranks under fp16: rank 1's gradient shard is made
    non-finite after the backward, rank 0's stays finite; every rank must
    skip the update (the flag is agreed) and back off its loss scale."""
    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator, GradScalerKwargs
    from accelerate_tpu_torch.parallel.sharding import local_grad

    inputs = read(d)
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      sharding_config=_sharding({"strategy": "FSDP", "fsdp": 2}),
                      kwargs_handlers=[GradScalerKwargs(init_scale=1024.0)])
    model = _model(inputs)
    opt = torch.optim.SGD(model.parameters(), **inputs["sgd"])
    model, opt = acc.prepare(model, opt)
    before = _full(model)
    reduce = acc._reduce_replicated

    def poisoned(params):
        reduce(params)
        if dist.get_rank() == 1:
            g = next(local_grad(p) for p in params if p.grad is not None and p.dim() > 1)
            g.view(-1)[0] = float("inf")

    acc._reduce_replicated = poisoned
    step = acc.build_train_step()
    local = _local_rows(acc.mesh, inputs["batch"])
    step({"input_ids": local, "labels": local})
    after = _full(model)
    write(d, "fp16", {"skipped": acc.optimizer_step_was_skipped,
                      "scale": acc.loss_scale.scale,
                      "unchanged": all(torch.equal(before[k], after[k]) for k in before)})


def sequence_worker(d: str, name: str):
    """The decoder's forward loss and one SGD update (the eager loop) on
    this world's mesh ``inputs["layouts"][name]`` (a ``sequence`` axis):
    each rank feeds its rows and its chunk of the sequence."""
    from accelerate_tpu_torch import Accelerator

    inputs = read(d)
    spec = inputs["layouts"][name]
    acc = Accelerator(cpu=True, sharding_config=_sharding(spec))
    model = _model(inputs)
    opt = torch.optim.SGD(model.parameters(), **inputs["sgd"])
    model, opt = acc.prepare(model, opt)
    # this rank's batch as its prepared loader gives it: the global batch
    # split over the data axes, its chunk of the sequence
    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration

    acc.dataloader_config = DataLoaderConfiguration(split_batches=True)
    rows = [{"ids": row} for row in inputs["batch"]]
    loader = acc.prepare(DataLoader(rows, batch_size=len(rows)))
    (batch,) = list(loader)
    local = batch["ids"]
    assert torch.equal(local, _local_rows(acc.mesh, inputs["batch"]))
    with torch.no_grad():
        forward = model(input_ids=local, labels=local)["loss"].item()
    loss = model(input_ids=local, labels=local)["loss"]
    acc.backward(loss)
    norm = acc.clip_grad_norm_(max_norm=1e9).item()  # the global norm; clips nothing
    opt.step()
    write(d, name, {"forward": forward, "loss": loss.item(), "grad_norm": norm,
                    "mesh": acc.state.mesh_shape,
                    "params": {k: v.numpy() for k, v in _full(model).items()}})


# ---------------------------------------------------------------------------
# operations, RNG, loaders
# ---------------------------------------------------------------------------


def ops_worker(d: str):
    """The six collectives, ``synchronize_rng_states`` and the sharded and
    dispatched loaders with ``gather_for_metrics`` on this world."""
    import random

    import torch.distributed as dist

    from accelerate_tpu_torch import Accelerator, DataLoader
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration
    from accelerate_tpu_torch.utils.random import synchronize_rng_states

    acc = Accelerator(cpu=True)
    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    t = torch.arange(3 * (r + 1), dtype=torch.float32).reshape(r + 1, 3) + 10 * r
    padded = ops.pad_across_processes(t, dim=0, pad_index=-1)
    out["pad"] = padded.numpy()
    out["pad_first"] = ops.pad_across_processes(t, dim=0, pad_index=-1, pad_first=True).numpy()
    out["gather"] = ops.gather(padded).numpy()
    out["gather_np"] = ops.gather(np.full((2,), r, np.int64))
    out["gather_object"] = ops.gather_object({"rank": r})
    out["gather_object_list"] = ops.gather_object([r, r * 10])
    out["reduce_sum"] = ops.reduce(torch.tensor([1.0 + r, 2.0]), "sum").numpy()
    out["reduce_mean"] = ops.reduce(torch.tensor([1.0 + r, 2.0]), "mean", scale=2.0).numpy()
    out["broadcast"] = ops.broadcast({"x": torch.full((2,), float(r))}, from_process=n - 1)["x"]
    out["broadcast_object_list"] = ops.broadcast_object_list([f"from {r}", r], from_process=1)
    # over the mesh's data axis (the default layout puts every rank on it)
    mesh = acc.mesh
    x = torch.tensor([float(r + 1)])
    out["psum"] = ops.psum(x, mesh=mesh).item()
    out["pmean"] = ops.pmean(x, mesh=mesh).item()
    out["all_gather_axis"] = ops.all_gather_axis(x, "data", mesh=mesh).tolist()
    out["global_batch"] = ops.make_global_batch({"x": np.zeros((2, 3))}, mesh)["x"].shape
    # rng: every generator seeded by rank, then the main process's given to all
    random.seed(r)
    np.random.seed(r)
    torch.manual_seed(r)
    gen = torch.Generator().manual_seed(100 + r)
    synchronize_rng_states(["python", "numpy", "torch", "generator"], generator=gen)
    out["rng"] = (random.random(), float(np.random.rand()), float(torch.rand(())),
                  float(torch.rand((), generator=gen)))
    # loaders over a dataset of 10 rows at a global batch of 2 x n
    inputs = read(d)
    data = [{"x": np.array([i], np.int64)} for i in range(inputs["rows"])]
    for mode, cfg in (("shard", DataLoaderConfiguration()),
                      ("dispatch", DataLoaderConfiguration(dispatch_batches=True))):
        acc_l = Accelerator(cpu=True, dataloader_config=cfg)
        loader = acc_l.prepare(DataLoader(data, batch_size=inputs["batch_size"]))
        seen, metrics = [], []
        for batch in loader:
            seen.append(batch["x"][:, 0].tolist())
            metrics.append(acc_l.gather_for_metrics(batch["x"][:, 0]).tolist())
        out[mode] = {"seen": seen, "metrics": metrics, "remainder": loader.remainder}
    write(d, "ops", out)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def checkpoint_worker(d: str):
    """FSDP on two ranks: one update, ``save_state`` (per-rank manifests),
    one more (the uninterrupted run); then a fresh run resumes from the
    checkpoint and takes that update again; and a run resumes from the
    reference's per-rank checkpoint in ``inputs["reference_dir"]`` and
    takes one update. Writes the losses and parameters of each."""
    from accelerate_tpu_torch import Accelerator

    inputs = read(d)

    def run():
        acc = Accelerator(cpu=True, sharding_config=_sharding({"strategy": "FSDP", "fsdp": 2}))
        model = _model(inputs)
        opt = torch.optim.SGD(model.parameters(), **inputs["sgd"])
        model, opt = acc.prepare(model, opt)
        step = acc.build_train_step()
        local = [_local_rows(acc.mesh, b) for b in inputs["batches"]]
        return acc, model, (lambda i: step({"input_ids": local[i], "labels": local[i]})
                            ["loss"].item())

    ckpt = os.path.join(d, "ckpt")
    acc, model, step = run()
    first = step(0)
    acc.save_state(ckpt)
    saved = {k: v.numpy() for k, v in _full(model).items()}
    second = step(1)
    a_params = {k: v.numpy() for k, v in _full(model).items()}
    acc.free_memory()
    acc, model, step = run()
    acc.load_state(ckpt)
    loaded = {k: v.numpy() for k, v in _full(model).items()}
    resumed = step(1)
    b_params = {k: v.numpy() for k, v in _full(model).items()}
    acc.free_memory()
    acc, model, step = run()
    acc.load_state(inputs["reference_dir"])
    from_ref = step(1)
    c_params = {k: v.numpy() for k, v in _full(model).items()}
    write(d, "ckpt", {"first": first, "second": second, "resumed": resumed,
                      "saved": saved, "loaded": loaded, "a": a_params, "b": b_params,
                      "from_reference": from_ref, "c": c_params})


# ---------------------------------------------------------------------------
# the bidirectional families on a mesh
# ---------------------------------------------------------------------------


def family_model(family: str, config: dict, weights: dict, mesh=None):
    """A port EncoderClassifier ("encoder") or Seq2SeqLM ("seq2seq") with
    ``weights``, fp32 masters on the CPU."""
    from accelerate_tpu_torch.models.configs import EncoderConfig
    from accelerate_tpu_torch.models.encoder import EncoderClassifier
    from accelerate_tpu_torch.models.seq2seq import Seq2SeqConfig, Seq2SeqLM

    cls, cfg = ((EncoderClassifier, EncoderConfig.tiny(**config)) if family == "encoder"
                else (Seq2SeqLM, Seq2SeqConfig.tiny(**config)))
    return cls(cfg, device="cpu", param_dtype=torch.float32, mesh=mesh).load_params(
        {k: torch.from_numpy(v) for k, v in weights.items()})


def family_step(acc, model, batch: dict, lr: float) -> dict:
    """One SGD update of the eager loop: loss, the global grad norm, and
    the parameters after it."""
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    model, opt = acc.prepare(model, opt)
    loss = model(**batch)["loss"]
    acc.backward(loss)
    norm = acc.clip_grad_norm_(max_norm=1e9).item()  # the global norm; clips nothing
    opt.step()
    return {"loss": loss.item(), "grad_norm": norm,
            "params": {k: v.numpy() for k, v in _full(model).items()}}


def _local_batch(mesh, batch: dict) -> dict:
    """Every leaf's rows for this rank's data-axes shard, and its chunk of
    dim 1 on a sequence axis (a leaf of one dim keeps its rows whole)."""
    from accelerate_tpu_torch.parallel.mesh import axis_index

    i, n = axis_index(mesh, ("replica", "data", "fsdp"))
    c, m = axis_index(mesh, ("sequence",))
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // n
        v = v[i * rows:(i + 1) * rows]
        if v.ndim >= 2:
            w = v.shape[1] // m
            v = v[:, c * w:(c + 1) * w]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def family_worker(d: str):
    """Each case of ``inputs["cases"]``: a family's one update on this
    world's mesh (a data, fsdp or sequence layout)."""
    from accelerate_tpu_torch import Accelerator

    inputs = read(d)
    results = {}
    for key, case in inputs["cases"].items():
        acc = Accelerator(cpu=True, sharding_config=_sharding(case["layout"]))
        model = family_model(case["family"], case["config"], case["weights"])
        results[key] = family_step(acc, model, _local_batch(acc.mesh, case["batch"]),
                                   inputs["lr"])
        acc.free_memory()
    write(d, "family", results)


# ---------------------------------------------------------------------------
# pipeline parallelism over the stage axis
# ---------------------------------------------------------------------------


def _held(model) -> dict:
    """This rank's parameters, whole (its stages' blocks and the
    replicated rest)."""
    return {k: v.numpy() for k, v in _full(model).items()}


def pipeline_worker(d: str, name: str):
    """Each layout of ``inputs["pipeline"][name]`` on this world, in turn:
    the pipelined decoder built on the Accelerator's stage mesh (each rank
    builds only its stage's blocks), one SGD update of the global batch
    through ``build_train_step`` (GPipe, or 1F1B's value-and-grad), with
    ``clip_grad_norm_`` where the layout asks; writes the loss, the grad
    norm, the parameters this rank holds and their count. With a
    ``"checkpoint"`` entry (world 2): a run resumes from the reference's
    pipelined checkpoint and saves its own state for the reference to
    resume."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models.configs import DecoderConfig
    from accelerate_tpu_torch.models.decoder import DecoderLM

    inputs = read(d)
    results = {}

    def build(spec):
        acc = Accelerator(cpu=True, sharding_config=_sharding(spec["layout"]))
        cfg = DecoderConfig.tiny(**inputs["config"], **spec["pipeline"])
        model = DecoderLM(cfg, device="cpu", param_dtype=torch.float32, mesh=acc.mesh)
        model.load_params({k: torch.from_numpy(v) for k, v in inputs["weights"].items()})
        opt = torch.optim.SGD(model.parameters(), **inputs["sgd"])
        model, opt = acc.prepare(model, opt)
        return acc, model, opt

    for key, spec in inputs["pipeline"][name].items():
        acc, model, opt = build(spec)
        if "loader" not in results:  # the rows a prepared loader gives this rank
            from accelerate_tpu_torch.data import DataLoader

            loader = acc.prepare(DataLoader(torch.arange(32), batch_size=8))
            results["loader"] = [b.tolist() for b in loader]
        res = {"held": list(model.held_layers()),
               "numel": sum(p.numel() for p in model.parameters()),
               "mesh": acc.state.mesh_shape}
        if spec.get("clip"):
            acc.clip_grad_norm_(max_norm=inputs["clip"])
        step = acc.build_train_step()
        local = _local_rows(acc.mesh, inputs["batch"])
        m = step({"input_ids": local, "labels": local})
        from torch.distributed.tensor import DTensor

        res.update(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                   one_f_one_b=getattr(model, "last_schedule", None) is not None,
                   sharded=sum(isinstance(p, DTensor) for p in model.parameters()),
                   params=_held(model))
        results[key] = res
        acc.free_memory()
    if name in inputs.get("checkpoint", {}):
        spec = inputs["checkpoint"][name]
        acc, model, opt = build(spec)
        acc.load_state(inputs["reference_dir"])
        results["loaded"] = _held(model)
        acc.save_state(os.path.join(d, "ckpt"))
        # inference on the stage mesh: every rank folds every block in, and
        # prepare_pippy splits it over the stage axis again
        from accelerate_tpu_torch.generation import depipeline
        from accelerate_tpu_torch.inference import prepare_pippy

        ids = torch.from_numpy(inputs["batch"][:4]).long()
        with torch.no_grad():
            flat = depipeline(model)
            results["depipelined"] = {"logits": flat(ids).numpy(),
                                      "layers": sum(1 for _ in flat.layers.parameters())}
            pipelined = prepare_pippy(model, num_microbatches=2)
            results["pippy"] = {"logits": pipelined(ids[:3]).numpy(),
                                "held": list(pipelined.model.held_layers())}
        acc.free_memory()
    write(d, name, results)
