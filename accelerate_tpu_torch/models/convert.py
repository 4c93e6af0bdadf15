"""Weights for the port's models: conversion from and to the reference's
parameter tree, and a seeded random init on the device.

The port's weights are a flat dict keyed like the model's
``state_dict()``, with the reference's leaf layouts (``wq [E, H, D]``,
``wk``/``wv [E, KVH, D]``, ``wo [H, D, E]``, ``w_gate``/``w_up [E, M]``,
``w_down [M, E]``, ``embedding [V, E]``, ``lm_head [E, V]``). Load them
with the model's ``load_params``. Three families, each with its
reference names:

- ``DecoderLM`` (``DecoderConfig``): ``embedding``, ``ln_final``,
  ``lm_head`` when untied, and ``layers.{i}.ln_attn`` / ``ln_mlp`` /
  ``attn.wq`` ... / ``mlp.w_down``, the reference's
  ``layers/block/attn/wq`` stacked along the layer axis
  (``scan_layers``) or ``layer_{i}/attn/wq`` unrolled;
- ``Seq2SeqLM`` (``Seq2SeqConfig``): ``embedding``, ``lm_head`` when
  untied, ``ln_enc``, ``ln_dec``, ``encoder.{i}.{ln_attn, ln_mlp, attn.*,
  mlp.*}`` and ``decoder.{i}.{ln_self, ln_cross, ln_mlp, self_attn.*,
  cross_attn.*, mlp.*}``, the reference's ``encoder/layers/block/...`` and
  ``decoder/layers/block/...``, always stacked (its stacks always scan);
- ``EncoderClassifier`` (``EncoderConfig``): ``word_embedding``,
  ``position_embedding``, ``type_embedding``, ``ln_embed_scale`` /
  ``_bias``, ``pooler_kernel`` / ``_bias``, ``classifier_kernel`` /
  ``_bias`` and ``layers.{i}.{wq, wk, wv, wo, ln1_scale, ln1_bias,
  ln2_scale, ln2_bias, w_in, b_in, w_out, b_out}``, the reference's
  unscanned ``layer_{i}/...``.

:func:`from_reference` takes the reference's tree, nested or flat (its
checkpoint keys) and returns per-layer views without copying: rows of a
stacked tensor (of a memory-mapped checkpoint too), or
:meth:`QuantizedWeight.layer` views of a stacked quantized leaf.
:func:`to_reference` turns a weight dict (weights, or gradients keyed
alike) back into the reference's tree (stacked where the reference
stacks), so tests compare the two leaf by leaf, and
:func:`export_reference_checkpoint` writes one as the reference's
checkpoint, a layer slice at a time.

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
from .configs import DecoderConfig, EncoderConfig
from .seq2seq import Seq2SeqConfig

# the blocks' weight names, in their modules' state_dict() order
_DECODER_BLOCK = ("ln_attn", "ln_mlp", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                  "mlp.w_gate", "mlp.w_up", "mlp.w_down")
_SEQ2SEQ_DECODER_BLOCK = ("ln_self", "ln_cross", "ln_mlp",
                          *(f"{m}.{w}" for m in ("self_attn", "cross_attn")
                            for w in ("wq", "wk", "wv", "wo")),
                          "mlp.w_gate", "mlp.w_up", "mlp.w_down")
_ENCODER_BLOCK = ("wq", "wk", "wv", "wo", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                  "w_in", "b_in", "w_out", "b_out")
_ENCODER_TOP = ("word_embedding", "position_embedding", "type_embedding", "ln_embed_scale",
                "ln_embed_bias", "pooler_kernel", "pooler_bias", "classifier_kernel",
                "classifier_bias")
CONFIGS = (DecoderConfig, Seq2SeqConfig, EncoderConfig)


def model_class(config):
    """The port's model of a config: ``DecoderLM``, ``Seq2SeqLM`` or
    ``EncoderClassifier``."""
    if isinstance(config, Seq2SeqConfig):
        from .seq2seq import Seq2SeqLM

        return Seq2SeqLM
    if isinstance(config, EncoderConfig):
        from .encoder import EncoderClassifier

        return EncoderClassifier
    if isinstance(config, DecoderConfig):
        from .decoder import DecoderLM

        return DecoderLM
    raise TypeError(f"no port model for {type(config).__name__}")


def layout_config(model):
    """The config whose reference layout a model's weights take (a
    ``DecoderLM``, ``Seq2SeqLM`` or ``EncoderClassifier``), else None: any
    other module keeps its own names."""
    from .decoder import _Model

    return model.config if isinstance(model, _Model) else None


def _stacks(config) -> list:
    """``[(port prefix, reference prefix of a stacked leaf or None for the
    unrolled layer_{i}, layers, block weight names)]`` of a family."""
    if isinstance(config, Seq2SeqConfig):
        return [("encoder", "encoder/layers/block", config.num_layers, _DECODER_BLOCK),
                ("decoder", "decoder/layers/block", config.num_decoder_layers,
                 _SEQ2SEQ_DECODER_BLOCK)]
    if isinstance(config, EncoderConfig):
        return [("layers", None, config.num_layers, _ENCODER_BLOCK)]
    return [("layers", "layers/block" if config.scan_layers else None, config.num_layers,
             _DECODER_BLOCK)]


def _stacked(config):
    """``config`` as the reference's stacked tree lays it out (a
    ``DecoderConfig`` with ``scan_layers``; the other families have one
    layout)."""
    return dataclasses.replace(config, scan_layers=True) if isinstance(config, DecoderConfig) \
        else config


def reference_leaves(params) -> dict:
    """The reference's tree, nested or flat, as ``{flat name: leaf}``; a
    node that is not a dict (a tensor, a numpy array, a QuantizedWeight)
    is one leaf."""
    return flatten_pytree(params, is_leaf=lambda node: not isinstance(node, Mapping))


def locate(port_name: str, config):
    """(reference flat name, layer index within a stacked leaf or None,
    the stack's layer count or None) of a port weight name."""
    for prefix, ref_prefix, layers, _ in _stacks(config):
        if port_name.startswith(prefix + "."):
            _, i, name = port_name.split(".", 2)
            path = name.replace(".", "/")
            if ref_prefix is None:
                return f"layer_{i}/{path}", None, None
            return f"{ref_prefix}/{path}", int(i), layers
    return port_name, None, None


def block_of(port_name: str, config):
    """(the block module that owns a weight, the weight's name in its
    block prefixed by the stack's): ``("encoder.3", "encoder.attn.wq")``;
    ``("", name)`` for a top-level weight."""
    for prefix, _, _, _ in _stacks(config):
        if port_name.startswith(prefix + "."):
            _, i, name = port_name.split(".", 2)
            return f"{prefix}.{i}", f"{prefix}.{name}"
    return "", port_name


def port_names(config) -> list:
    """The port's weight names of a family, block weights in layer
    order."""
    blocks = [f"{prefix}.{i}.{n}" for prefix, _, layers, leaves in _stacks(config)
              for i in range(layers) for n in leaves]
    if isinstance(config, EncoderConfig):
        return list(_ENCODER_TOP) + blocks
    head = [] if config.tie_embeddings else ["lm_head"]
    if isinstance(config, Seq2SeqConfig):
        return ["embedding", *head, "ln_enc", "ln_dec"] + blocks
    return ["embedding"] + blocks + ["ln_final"] + head


def reference_layout(config, weights: Mapping) -> dict:
    """``{reference flat name: (port names, shape)}`` in the reference's
    tree order, for ``weights`` keyed by the port's names (anything with a
    ``shape``: tensors, meta tensors, numpy arrays). A block leaf stacked
    along the layer axis lists its layers' names
    in layer order under the shape [L, ...]; any other leaf has one name
    and that weight's shape."""
    groups: dict = {}
    for name in port_names(config):
        ref, i, _ = locate(name, config)
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


def from_reference(params, config, dtype: Optional[torch.dtype] = None) -> dict:
    """The reference model's parameter tree -> the port's weight dict, for
    any of the three families (``config`` says which). ``params`` is the
    unboxed nested tree (leaves numpy, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) or a flat dict under
    the reference's checkpoint names; leaves may be numpy arrays, tensors
    or QuantizedWeights. A decoder's stacked tree (``scan_layers=True``:
    every block leaf under ``layers/block/...`` with a leading layer axis)
    and unrolled one (``layer_{i}/...``) are both accepted; stacked leaves
    give per-layer views. With ``dtype``, numpy and tensor leaves become
    CPU tensors of it (``torch.float32`` for training's master weights)."""
    leaves = reference_leaves(params)
    cfg = config
    if isinstance(config, DecoderConfig):
        stacked = any(k.startswith("layers/") for k in leaves)
        cfg = dataclasses.replace(config, scan_layers=stacked)
    out = {}
    for name in port_names(cfg):
        ref, i, layers = locate(name, cfg)
        leaf = leaves[ref]
        if not isinstance(leaf, torch.Tensor) and not hasattr(leaf, "layer"):
            leaf = np.asarray(leaf)  # numpy (or JAX) arrays
        if i is not None:
            if leaf.shape[0] != layers:
                raise ValueError(f"{ref} stacks {leaf.shape[0]} layers, config has {layers}")
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


def to_reference(weights: dict, config) -> dict:
    """The port's weight dict (tensors or numpy, keyed like the model's
    ``state_dict()``; gradients keyed alike work the same) -> the
    reference's tree of fp32 numpy arrays, block leaves stacked along the
    layer axis where the reference scans them (a decoder's and the seq2seq
    stacks'; BERT's ``layer_{i}`` stay unrolled)."""

    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, dtype=np.float32)

    layout = reference_layout(_stacked(config), weights)
    return unflatten_to_like({ref: np.stack([arr(weights[n]) for n in names]).reshape(shape)
                              for ref, (names, shape) in layout.items()})


def reference_entries(weights: Mapping, config, prefix: str = "",
                      dtype: Optional[torch.dtype] = None) -> list:
    """The port's weight dict (tensors on any device, or anything keyed
    alike: gradients, Adam moments) as ``(prefix + reference name, shape,
    dtype, fetch)`` entries of ``utils/serialization.save_entries``, in
    the reference's tree order, block leaves stacked along the layer axis
    or unrolled as the reference lays them out. ``fetch`` yields a stacked
    leaf's layer slices one at a time, so a writer holds one slice on the
    host, not the stack. ``dtype`` None keeps each leaf's own."""
    out = []
    for ref, (names, shape) in reference_layout(config, weights).items():
        dt = dtype or weights[names[0]].dtype
        out.append((prefix + ref, shape, dt,
                    (lambda ns, dt: lambda: (weights[n].detach().to(dt) for n in ns))(names, dt)))
    return out


def export_reference_checkpoint(weights: dict, config, path,
                                dtype: torch.dtype = torch.bfloat16,
                                max_shard_size: Optional[int] = None) -> list:
    """Write the port's weight dict (tensors, on any device) as the
    reference's checkpoint of ``dtype`` at ``path``: its flat names in its
    tree order, block leaves stacked or unrolled as the reference lays them
    out, sharded with an index when
    ``max_shard_size`` is given, one layer slice on the host at a time
    (:func:`reference_entries`). Returns the files written."""
    return save_entries(reference_entries(weights, config, dtype=dtype), path, max_shard_size)


# optax.adamw(schedule) is chain(scale_by_adam, add_decayed_weights,
# scale_by_learning_rate): its state flattens to the Adam count and
# moments under "0/" and, when the learning rate is a schedule, the
# schedule's count under "2/" (a constant rate keeps no state)
ADAM_COUNT, MU, NU, SCHEDULE_COUNT = "0/count", "0/mu/", "0/nu/", "2/count"


def _moment_layout(model):
    """(parameters by name, config or None): a port model maps through the
    reference's layout, any other module keeps its own names."""
    params = dict(model.named_parameters())
    config = getattr(model, "config", None)
    return params, (config if isinstance(config, CONFIGS) else None)


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
    For a port model the names and the layout are the reference's
    weights' (:func:`reference_entries`: a stacked moment is
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


def random_params(config, seed: int = 0, device: Optional[torch.device] = None,
                  dtype: Optional[torch.dtype] = None) -> dict:
    """Seeded random weights of any of the three families, made on
    ``device`` (``None`` means CUDA; raises without it unless
    ``device="cpu"``): normal(0.02) embeddings, fan-in scaled normal
    matmul weights (the reference's initializers), unit norm scales, zero
    norm and linear biases. ``dtype`` None gives matmul weights, biases and
    embeddings in the compute dtype and fp32 norms (serving); a dtype gives
    every weight in it (``torch.float32`` for training's master
    weights)."""
    from .decoder import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = dtype or config.dtype
    norm_dt = dtype or torch.float32

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    def ones(n):
        return torch.ones(n, device=dev, dtype=norm_dt)

    if isinstance(config, EncoderConfig):
        return _random_encoder(config, normal, ones, dev, dt, norm_dt)
    e, h, kv, d, m, v = (config.embed_dim, config.num_heads, config.num_kv_heads,
                         config.head_dim, config.mlp_dim, config.vocab_size)

    def attention(p):
        return {p + "wq": normal((e, h, d), e ** -0.5), p + "wk": normal((e, kv, d), e ** -0.5),
                p + "wv": normal((e, kv, d), e ** -0.5), p + "wo": normal((h, d, e), (h * d) ** -0.5)}

    def mlp(p):
        return {p + "mlp.w_gate": normal((e, m), e ** -0.5), p + "mlp.w_up": normal((e, m), e ** -0.5),
                p + "mlp.w_down": normal((m, e), m ** -0.5)}

    if isinstance(config, Seq2SeqConfig):
        out = {"embedding": normal((v, e), 0.02)}
        if not config.tie_embeddings:
            out["lm_head"] = normal((e, v), e ** -0.5)
        out["ln_enc"], out["ln_dec"] = ones(e), ones(e)
        for i in range(config.num_layers):
            p = f"encoder.{i}."
            out.update({p + "ln_attn": ones(e), p + "ln_mlp": ones(e)})
            out.update(attention(p + "attn."))
            out.update(mlp(p))
        for i in range(config.num_decoder_layers):
            p = f"decoder.{i}."
            out.update({p + n: ones(e) for n in ("ln_self", "ln_cross", "ln_mlp")})
            out.update(attention(p + "self_attn."))
            out.update(attention(p + "cross_attn."))
            out.update(mlp(p))
        return out
    out = {"embedding": normal((v, e), 0.02), "ln_final": ones(e)}
    if not config.tie_embeddings:
        out["lm_head"] = normal((e, v), e ** -0.5)
    for i in range(config.num_layers):
        p = f"layers.{i}."
        out[p + "ln_attn"] = ones(e)
        out[p + "ln_mlp"] = ones(e)
        out.update(attention(p + "attn."))
        out.update(mlp(p))
    return out


def _random_encoder(config: EncoderConfig, normal, ones, dev, dt, norm_dt) -> dict:
    e, h, d, m = config.embed_dim, config.num_heads, config.head_dim, config.mlp_dim
    out = {"word_embedding": normal((config.vocab_size, e), 0.02),
           "position_embedding": normal((config.max_seq_len, e), 0.02),
           "type_embedding": normal((config.type_vocab_size, e), 0.02),
           "ln_embed_scale": ones(e), "ln_embed_bias": torch.zeros(e, device=dev, dtype=norm_dt),
           "pooler_kernel": normal((e, e), e ** -0.5),
           "pooler_bias": torch.zeros(e, device=dev, dtype=dt),
           "classifier_kernel": normal((e, config.num_labels), e ** -0.5),
           "classifier_bias": torch.zeros(config.num_labels, device=dev, dtype=dt)}
    for i in range(config.num_layers):
        p = f"layers.{i}."
        out.update({p + "wq": normal((e, h, d), e ** -0.5), p + "wk": normal((e, h, d), e ** -0.5),
                    p + "wv": normal((e, h, d), e ** -0.5),
                    p + "wo": normal((h, d, e), (h * d) ** -0.5)})
        for j in (1, 2):
            out[p + f"ln{j}_scale"] = ones(e)
            out[p + f"ln{j}_bias"] = torch.zeros(e, device=dev, dtype=norm_dt)
        out.update({p + "w_in": normal((e, m), e ** -0.5),
                    p + "b_in": torch.zeros(m, device=dev, dtype=dt),
                    p + "w_out": normal((m, e), m ** -0.5),
                    p + "b_out": torch.zeros(e, device=dev, dtype=dt)})
    return out
