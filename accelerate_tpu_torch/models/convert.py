"""Weights for the port's ``DecoderLM``: conversion from and to the
reference's parameter tree, and a seeded random init on the device.

The port's weights are a flat dict keyed like ``DecoderLM.state_dict()``
(``embedding``, ``ln_final``, ``lm_head`` when untied, and
``layers.{i}.ln_attn`` / ``ln_mlp`` / ``attn.wq`` ... / ``mlp.w_down``),
with the reference's leaf layouts: ``wq [E, H, D]``, ``wk``/``wv
[E, KVH, D]``, ``wo [H, D, E]``, ``w_gate``/``w_up [E, M]``,
``w_down [M, E]``, ``embedding [V, E]``, ``lm_head [E, V]``.
Load them with :meth:`DecoderLM.load_params`.

:func:`from_reference` takes the reference's tree, nested or flat (its
checkpoint keys: ``layers/block/attn/wq`` stacked along the layer axis,
or ``layer_{i}/attn/wq`` unrolled) and returns per-layer views without
copying: rows of a stacked tensor (of a memory-mapped checkpoint too),
or :meth:`QuantizedWeight.layer` views of a stacked quantized leaf.
:func:`to_reference` turns a weight dict (weights, or gradients keyed
alike) back into the reference's scan-stacked tree, so tests compare the
two leaf by leaf, and :func:`export_reference_checkpoint` writes one as
the reference's stacked checkpoint, a layer slice at a time.

:func:`optimizer_state_to_reference` and
:func:`optimizer_state_from_reference` map a torch ``AdamW``'s state to
``optax.adamw``'s and back, through the same layout as the weights.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..utils.serialization import flatten_pytree, save_entries, unflatten_to_like
from .configs import DecoderConfig

_BLOCK_LEAVES = {
    "ln_attn": ("ln_attn",),
    "ln_mlp": ("ln_mlp",),
    "attn.wq": ("attn", "wq"),
    "attn.wk": ("attn", "wk"),
    "attn.wv": ("attn", "wv"),
    "attn.wo": ("attn", "wo"),
    "mlp.w_gate": ("mlp", "w_gate"),
    "mlp.w_up": ("mlp", "w_up"),
    "mlp.w_down": ("mlp", "w_down"),
}


def reference_leaves(params) -> dict:
    """The reference's tree, nested or flat, as ``{flat name: leaf}``; a
    node that is not a dict (a tensor, a numpy array, a QuantizedWeight)
    is one leaf."""
    return flatten_pytree(params, is_leaf=lambda node: not isinstance(node, Mapping))


def _reference_name(port_name: str, config: DecoderConfig):
    """(reference flat name, layer index within a stacked leaf or None) of
    a port weight name."""
    if not port_name.startswith("layers."):
        return port_name, None
    _, i, name = port_name.split(".", 2)
    path = "/".join(_BLOCK_LEAVES[name])
    if config.scan_layers:
        return f"layers/block/{path}", int(i)
    return f"layer_{i}/{path}", None


def port_names(config: DecoderConfig) -> list:
    """The port's weight names, in ``DecoderLM.state_dict()`` order."""
    names = ["embedding"]
    names += [f"layers.{i}.{n}" for i in range(config.num_layers)
              for n in ("ln_attn", "ln_mlp", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                        "mlp.w_gate", "mlp.w_up", "mlp.w_down")]
    names.append("ln_final")
    if not config.tie_embeddings:
        names.append("lm_head")
    return names


def reference_layout(config: DecoderConfig, weights: Mapping) -> dict:
    """``{reference flat name: (port names, shape)}`` in the reference's
    tree order, for ``weights`` keyed by the port's names (anything with a
    ``shape``: tensors, meta tensors, numpy arrays). A block leaf stacked
    along the layer axis (``config.scan_layers``) lists its layers' names
    in layer order under the shape [L, ...]; any other leaf has one name
    and that weight's shape."""
    groups: dict = {}
    for name in port_names(config):
        ref, i = _reference_name(name, config)
        groups.setdefault(ref, ([], i is not None))[0].append(name)
    out = {}
    for ref in sorted(groups, key=lambda k: k.split("/")):
        names, stacked = groups[ref]
        shape = tuple(weights[names[0]].shape)
        out[ref] = (names, (len(names),) + shape if stacked else shape)
    return out


def _layer(leaf, i: int):
    """Row ``i`` of a stacked leaf, without a copy."""
    return leaf.layer(i) if hasattr(leaf, "layer") else leaf[i]


def from_reference(params, config: DecoderConfig, dtype: Optional[torch.dtype] = None) -> dict:
    """The reference ``DecoderLM``'s parameter tree -> the port's weight
    dict. ``params`` is the unboxed nested tree (leaves numpy, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) or a flat dict under
    the reference's checkpoint names; leaves may be numpy arrays, tensors
    or QuantizedWeights. Stacked trees (``scan_layers=True``: every block
    leaf under ``layers/block/...`` with a leading layer axis) and unrolled
    ones (``layer_{i}/...``) are both accepted: stacked leaves give
    per-layer views. With ``dtype``, numpy and tensor leaves become CPU
    tensors of it (``torch.float32`` for training's master weights)."""
    leaves = reference_leaves(params)
    stacked = any(k.startswith("layers/") for k in leaves)
    cfg = dataclasses.replace(config, scan_layers=stacked)
    out = {}
    for name in port_names(cfg):
        ref, i = _reference_name(name, cfg)
        leaf = leaves[ref]
        if not isinstance(leaf, torch.Tensor) and not hasattr(leaf, "layer"):
            leaf = np.asarray(leaf)  # numpy (or JAX) arrays
        if i is not None:
            if leaf.shape[0] != cfg.num_layers:
                raise ValueError(f"{ref} stacks {leaf.shape[0]} layers, config has "
                                 f"{cfg.num_layers}")
            leaf = _layer(leaf, i)
        out[name] = leaf
    if dtype is not None:
        out = {k: _to_dtype(v, dtype) for k, v in out.items()}
    return out


def _to_dtype(v, dtype):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v)).to(dtype)
    if isinstance(v, torch.Tensor):
        return v.to("cpu", dtype)
    return v


def to_reference(weights: dict, config: DecoderConfig) -> dict:
    """The port's weight dict (tensors or numpy, keyed like
    ``DecoderLM.state_dict()``; gradients keyed alike work the same) -> the
    reference's scan-stacked tree of fp32 numpy arrays: ``embedding``,
    ``ln_final``, ``lm_head`` when untied, and every block leaf under
    ``layers/block/...`` with a leading layer axis."""

    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, dtype=np.float32)

    layout = reference_layout(dataclasses.replace(config, scan_layers=True), weights)
    return unflatten_to_like({ref: np.stack([arr(weights[n]) for n in names]).reshape(shape)
                              for ref, (names, shape) in layout.items()})


def reference_entries(weights: Mapping, config: DecoderConfig, prefix: str = "",
                      dtype: Optional[torch.dtype] = None) -> list:
    """The port's weight dict (tensors on any device, or anything keyed
    alike: gradients, Adam moments) as ``(prefix + reference name, shape,
    dtype, fetch)`` entries of ``utils/serialization.save_entries``, in
    the reference's tree order, block leaves stacked along the layer axis
    (``config.scan_layers``) or unrolled. ``fetch`` yields a stacked
    leaf's layer slices one at a time, so a writer holds one slice on the
    host, not the stack. ``dtype`` None keeps each leaf's own."""
    out = []
    for ref, (names, shape) in reference_layout(config, weights).items():
        dt = dtype or weights[names[0]].dtype
        out.append((prefix + ref, shape, dt,
                    (lambda ns, dt: lambda: (weights[n].detach().to(dt) for n in ns))(names, dt)))
    return out


def export_reference_checkpoint(weights: dict, config: DecoderConfig, path,
                                dtype: torch.dtype = torch.bfloat16,
                                max_shard_size: Optional[int] = None) -> list:
    """Write the port's weight dict (tensors, on any device) as the
    reference's checkpoint of ``dtype`` at ``path``: its flat names in its
    tree order, block leaves stacked along the layer axis
    (``config.scan_layers``) or unrolled, sharded with an index when
    ``max_shard_size`` is given, one layer slice on the host at a time
    (:func:`reference_entries`). Returns the files written."""
    return save_entries(reference_entries(weights, config, dtype=dtype), path, max_shard_size)


# optax.adamw(schedule) is chain(scale_by_adam, add_decayed_weights,
# scale_by_learning_rate): its state flattens to the Adam count and
# moments under "0/" and, when the learning rate is a schedule, the
# schedule's count under "2/" (a constant rate keeps no state)
ADAM_COUNT, MU, NU, SCHEDULE_COUNT = "0/count", "0/mu/", "0/nu/", "2/count"


def _moment_layout(model):
    """(parameters by name, config or None): a ``DecoderLM`` maps through
    the reference's layout, any other module keeps its own names."""
    params = dict(model.named_parameters())
    config = getattr(model, "config", None)
    return params, (config if isinstance(config, DecoderConfig) else None)


def _check_adamw(optimizer):
    if not isinstance(optimizer, torch.optim.AdamW):
        raise TypeError(f"optax.adamw's state maps to torch.optim.AdamW's, not "
                        f"{type(optimizer).__name__}'s")
    if any(group.get("amsgrad") for group in optimizer.param_groups):
        raise NotImplementedError("optax.adamw has no amsgrad state")


def _lambda_schedule(scheduler):
    """The torch ``LambdaLR`` a schedule count maps to, or None."""
    inner = getattr(scheduler, "scheduler", scheduler)
    return inner if isinstance(inner, torch.optim.lr_scheduler.LambdaLR) else None


def optimizer_state_to_reference(optimizer, model, scheduler=None) -> list:
    """A torch ``AdamW``'s state as ``optax.adamw``'s, in
    ``(key, shape, dtype, fetch)`` entries (``utils/serialization``):
    ``0/count`` (int32, the update count, every parameter's ``step``),
    ``0/mu/<name>`` (``exp_avg``) and ``0/nu/<name>`` (``exp_avg_sq``),
    fp32, and ``2/count`` (int32, ``LambdaLR.last_epoch``) when
    ``scheduler`` is a ``LambdaLR``, as optax keeps a schedule's count.
    For a ``DecoderLM`` the names and the stacked layout are the
    reference's weights' (:func:`reference_entries`: a stacked moment is
    fetched a layer slice at a time); any other module's moments keep
    its parameter names and have no reference counterpart. A parameter
    the optimizer has not updated yet has zero moments, as optax's
    initial state. betas, eps and weight decay are hyperparameters: no
    optax state holds them."""
    _check_adamw(optimizer)
    params, config = _moment_layout(model)
    counts = {int(optimizer.state[p]["step"]) for p in params.values()
              if "step" in optimizer.state.get(p, {})}
    if len(counts) > 1:
        raise ValueError(f"the parameters' update counts differ ({sorted(counts)}): "
                         "optax keeps one count")
    count = counts.pop() if counts else 0

    def moments(key):
        return {n: (optimizer.state[p][key] if key in optimizer.state.get(p, {})
                    else torch.zeros_like(p, dtype=torch.float32))
                for n, p in params.items()}

    def scalar(value):
        return (torch.Size(()), torch.int32,
                (lambda v: lambda: torch.tensor(v, dtype=torch.int32))(int(value)))

    entries = [(ADAM_COUNT, *scalar(count))]
    for prefix, key in ((MU, "exp_avg"), (NU, "exp_avg_sq")):
        m = moments(key)
        if config is not None:
            entries += reference_entries(m, config, prefix=prefix, dtype=torch.float32)
        else:
            entries += [(prefix + n, tuple(t.shape), torch.float32,
                         (lambda t: lambda: t.detach().float())(t)) for n, t in m.items()]
    sched = _lambda_schedule(scheduler)
    if sched is not None:
        entries.append((SCHEDULE_COUNT, *scalar(sched.last_epoch)))
    return entries


def _step_tensor(optimizer, group, p, count: int) -> torch.Tensor:
    """``count`` as a parameter's ``step``, where torch keeps it: beside the
    state it replaces, else on the parameter's device for a capturable or
    fused group and as a CPU scalar otherwise (torch's AdamW)."""
    old = optimizer.state.get(p, {}).get("step")
    if old is not None:
        return torch.full_like(old, count)
    on_param = group.get("capturable") or group.get("fused")
    return torch.tensor(float(count), dtype=torch.float32,
                        device=p.device if on_param else "cpu")


def optimizer_state_from_reference(flat: Mapping, optimizer, model, scheduler=None):
    """Load ``optax.adamw``'s state (the flat dict of an optimizer
    checkpoint, :func:`optimizer_state_to_reference`'s names) into a torch
    ``AdamW`` over ``model``'s parameters: every ``step`` becomes
    ``0/count``, ``exp_avg`` / ``exp_avg_sq`` the moments, each a new
    tensor like its parameter (its device and dtype), copied from a layer
    slice of the stacked leaf. With a ``LambdaLR`` ``scheduler`` and a
    ``2/count`` in ``flat``, the schedule moves to that count and each
    group's ``lr`` becomes ``base_lr * lambda(count)``, as optax
    evaluates its schedule. The optimizer keeps the betas, eps and weight
    decay it was built with (optax's state holds none)."""
    _check_adamw(optimizer)
    params, config = _moment_layout(model)
    count = int(flat[ADAM_COUNT])
    views = {}
    for prefix in (MU, NU):
        tree = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        views[prefix] = (from_reference(tree, config) if config is not None
                         else {n: tree[n] for n in params})
    group_of = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    for name, p in params.items():
        group = group_of[id(p)]
        state = {"step": _step_tensor(optimizer, group, p, count)}
        for prefix, key in ((MU, "exp_avg"), (NU, "exp_avg_sq")):
            src = views[prefix][name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{prefix}{name}: shape {tuple(src.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            state[key] = torch.empty_like(p, memory_format=torch.contiguous_format).copy_(src)
        optimizer.state[p] = state
    sched = _lambda_schedule(scheduler)
    if sched is not None and SCHEDULE_COUNT in flat:
        steps = int(flat[SCHEDULE_COUNT])
        sched.last_epoch = steps
        sched._step_count = steps + 1
        for group, base, fn in zip(optimizer.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(steps)
        sched._last_lr = [group["lr"] for group in optimizer.param_groups]


def random_params(config: DecoderConfig, seed: int = 0,
                  device: Optional[torch.device] = None,
                  dtype: Optional[torch.dtype] = None) -> dict:
    """Seeded random weights made on ``device`` (``None`` means CUDA; raises
    without it unless ``device="cpu"``): normal(0.02) embeddings, fan-in
    scaled normal matmul weights (the reference's initializers), unit
    norms. ``dtype`` None gives matmul weights and embeddings in the
    compute dtype and fp32 norms (serving); a dtype gives every weight in
    it (``torch.float32`` for training's master weights)."""
    from .decoder import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    e, h, kv, d, m, v = (config.embed_dim, config.num_heads, config.num_kv_heads,
                         config.head_dim, config.mlp_dim, config.vocab_size)
    dt = dtype or config.dtype
    norm_dt = dtype or torch.float32

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    out = {"embedding": normal((v, e), 0.02),
           "ln_final": torch.ones(e, device=dev, dtype=norm_dt)}
    if not config.tie_embeddings:
        out["lm_head"] = normal((e, v), e ** -0.5)
    for i in range(config.num_layers):
        p = f"layers.{i}."
        out[p + "ln_attn"] = torch.ones(e, device=dev, dtype=norm_dt)
        out[p + "ln_mlp"] = torch.ones(e, device=dev, dtype=norm_dt)
        out[p + "attn.wq"] = normal((e, h, d), e ** -0.5)
        out[p + "attn.wk"] = normal((e, kv, d), e ** -0.5)
        out[p + "attn.wv"] = normal((e, kv, d), e ** -0.5)
        out[p + "attn.wo"] = normal((h, d, e), (h * d) ** -0.5)
        out[p + "mlp.w_gate"] = normal((e, m), e ** -0.5)
        out[p + "mlp.w_up"] = normal((e, m), e ** -0.5)
        out[p + "mlp.w_down"] = normal((m, e), m ** -0.5)
    return out
