"""Weights for the port's models: conversion from and to the reference's
parameter tree, and a seeded random init on the device.

The port's weights are a flat dict keyed like the model's
``state_dict()``, with the reference's leaf layouts (``wq [E, H, D]``,
``wk``/``wv [E, KVH, D]``, ``wo [H, D, E]``, ``w_gate``/``w_up [E, M]``,
``w_down [M, E]``, ``embedding [V, E]``, ``lm_head [E, V]``). Load them
with the model's ``load_params``. Four families, each with its
reference names:

- ``DecoderLM`` (``DecoderConfig``): ``embedding``, ``ln_final``,
  ``lm_head`` when untied, and ``layers.{i}.ln_attn`` / ``ln_mlp`` /
  ``attn.wq`` ... / ``mlp.w_down``, the reference's
  ``layers/block/attn/wq`` stacked along the layer axis
  (``scan_layers``) or ``layer_{i}/attn/wq`` unrolled (an MoE decoder's
  blocks hold ``moe_mlp.router`` / ``w_gate`` / ``w_up`` / ``w_down`` in
  place of ``mlp.*``, laid out alike);
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
  unscanned ``layer_{i}/...``;
- ``ResNet`` (``VisionConfig``): the reference's own names with dots
  (``stem_conv.kernel``, ``stage{s}_block{b}.Conv_0.kernel``,
  ``...BatchNorm_0.scale``, ``classifier.bias``, ...), never stacked,
  its BatchNorm running averages (``...BatchNorm_0.mean`` / ``.var``)
  beside them: the reference's ``batch_stats`` collection, whose names
  here are ``batch_stats/...``. Conv kernels are OIHW in the port and
  HWIO in the reference; every conversion transposes them.

A transformer built with the delayed fp8 recipe (``use_fp8`` and
``fp8_recipe="delayed"``) holds its blocks' amax histories as buffers
(``layers.{i}.attn.wq_fp8`` ... ``mlp.down``, BERT's ``layers.{i}.mlp_in``
...): the reference's ``fp8_stats`` collection, laid out as its
parameters (``fp8_stats/layers/block/attn/wq_fp8`` [L, 2, H], or
``fp8_stats/layer_{i}/...`` unrolled); a tree may leave them out.

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
``optax.adamw``'s and a torch ``SGD``'s (its momentum) to
``optax.sgd``'s, and back, through the same layout as the weights.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..ops import fp8
from ..utils.serialization import flatten_pytree, save_entries, unflatten_to_like
from .configs import DecoderConfig, EncoderConfig, VisionConfig
from .seq2seq import Seq2SeqConfig

# the blocks' weight names, in their modules' state_dict() order
_DECODER_BLOCK = ("ln_attn", "ln_mlp", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                  "mlp.w_gate", "mlp.w_up", "mlp.w_down")
# an MoE decoder's block (moe_num_experts > 1): the router and the expert banks
_MOE_BLOCK = _DECODER_BLOCK[:6] + ("moe_mlp.router", "moe_mlp.w_gate", "moe_mlp.w_up",
                                   "moe_mlp.w_down")
_SEQ2SEQ_DECODER_BLOCK = ("ln_self", "ln_cross", "ln_mlp",
                          *(f"{m}.{w}" for m in ("self_attn", "cross_attn")
                            for w in ("wq", "wk", "wv", "wo")),
                          "mlp.w_gate", "mlp.w_up", "mlp.w_down")
_ENCODER_BLOCK = ("wq", "wk", "wv", "wo", "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias",
                  "w_in", "b_in", "w_out", "b_out")
_ENCODER_TOP = ("word_embedding", "position_embedding", "type_embedding", "ln_embed_scale",
                "ln_embed_bias", "pooler_kernel", "pooler_bias", "classifier_kernel",
                "classifier_bias")
CONFIGS = (DecoderConfig, Seq2SeqConfig, EncoderConfig, VisionConfig)
# the ResNet family's BatchNorm running averages: buffers, not parameters
BATCH_STATS = "batch_stats/"
# the delayed fp8 recipe's amax histories (ops/fp8.py): buffers of the
# transformer families' blocks, the reference's "fp8_stats" collection,
# laid out as its parameters are (stacked [L, 2, H] or per layer_{i})
FP8_STATS = "fp8_stats/"
_ATTN_HIST = fp8.ATTENTION_HISTORIES
_MLP_HIST = tuple("mlp." + n for n in fp8.MLP_HISTORIES)


def _histories(config, *groups) -> tuple:
    """The block's history buffer names (``prefix.name``), where ``config``
    asks for delayed fp8; none otherwise."""
    if not fp8.delayed(config):
        return ()
    return tuple(f"{p}.{n}" if p else n for p, names in groups for n in names)


class _Draws:
    """Seeded draws of one ``random_params`` call: ``normal`` in the
    matmul dtype ``dt``, norm-like leaves in ``norm_dt``."""

    def __init__(self, gen, dev, dt, norm_dt):
        self.gen, self.dev, self.dt, self.norm_dt = gen, dev, dt, norm_dt

    def normal(self, shape, std):
        return (torch.randn(shape, generator=self.gen, device=self.dev) * std).to(self.dt)

    def ones(self, n, dtype=None):
        return torch.ones(n, device=self.dev, dtype=dtype or self.norm_dt)

    def zeros(self, n, dtype=None):
        return torch.zeros(n, device=self.dev, dtype=dtype or self.norm_dt)


class _Family:
    """One family's layout beside the reference's tree: its model, its
    stacks of blocks, its weight names, its random weights, and how a
    weight outside the stacks crosses. The transformer families keep
    those weights' names and leaves as they are and hold no buffers."""

    def model(self):
        raise NotImplementedError

    def stacks(self, config) -> list:
        """``[(port prefix, reference prefix of a stacked leaf or None for
        the unrolled layer_{i}, layers, block weight names)]``."""
        return []

    def names(self, config, blocks: list) -> list:
        """The port's weight names, given the block weights in layer order."""
        raise NotImplementedError

    def random(self, config, draw: _Draws) -> dict:
        raise NotImplementedError

    def is_buffer(self, port_name: str) -> bool:
        """A buffer, not a parameter: optimizer moments have none, and a
        tree may leave it out. The transformer families' are the fp8 amax
        histories."""
        return port_name.rsplit(".", 1)[-1] in fp8.HISTORY_NAMES

    def ref_name(self, port_name: str) -> str:
        """The reference's flat name of a weight outside the stacks."""
        return port_name

    def ref_leaves(self, leaves: dict) -> dict:
        """The reference's flat tree as given -> the flat names
        ``ref_name`` gives."""
        return leaves

    def to_ref(self, x):
        """A port leaf (tensor or numpy) in the reference's layout."""
        return x

    def from_ref(self, x):
        """A reference leaf in the port's layout."""
        return x


def _attention_draws(draw: _Draws, config, p: str) -> dict:
    e, h, kv, d = config.embed_dim, config.num_heads, config.num_kv_heads, config.head_dim
    return {p + "wq": draw.normal((e, h, d), e ** -0.5),
            p + "wk": draw.normal((e, kv, d), e ** -0.5),
            p + "wv": draw.normal((e, kv, d), e ** -0.5),
            p + "wo": draw.normal((h, d, e), (h * d) ** -0.5)}


def _mlp_draws(draw: _Draws, config, p: str) -> dict:
    e, m, n = config.embed_dim, config.mlp_dim, getattr(config, "moe_num_experts", 0)
    if n > 1:
        # flax's variance_scaling counts the expert axis of an [E, in, out]
        # bank into its fan-in: E * in
        return {p + "moe_mlp.router": draw.normal((e, n), e ** -0.5),
                p + "moe_mlp.w_gate": draw.normal((n, e, m), (n * e) ** -0.5),
                p + "moe_mlp.w_up": draw.normal((n, e, m), (n * e) ** -0.5),
                p + "moe_mlp.w_down": draw.normal((n, m, e), (n * m) ** -0.5)}
    return {p + "mlp.w_gate": draw.normal((e, m), e ** -0.5),
            p + "mlp.w_up": draw.normal((e, m), e ** -0.5),
            p + "mlp.w_down": draw.normal((m, e), m ** -0.5)}


class _DecoderFamily(_Family):
    def model(self):
        from .decoder import DecoderLM

        return DecoderLM

    def stacks(self, config) -> list:
        moe = config.moe_num_experts > 1
        # an MoE block's experts run no fp8 (the reference's moe.py has none)
        block = (_MOE_BLOCK if moe else _DECODER_BLOCK) + _histories(
            config, ("attn", _ATTN_HIST), ("", () if moe else _MLP_HIST))
        return [("layers", "layers/block" if config.scan_layers else None, config.num_layers,
                 block)]

    def names(self, config, blocks: list) -> list:
        head = [] if config.tie_embeddings else ["lm_head"]
        return ["embedding"] + blocks + ["ln_final"] + head

    def random(self, config, draw: _Draws) -> dict:
        e = config.embed_dim
        out = {"embedding": draw.normal((config.vocab_size, e), 0.02), "ln_final": draw.ones(e)}
        if not config.tie_embeddings:
            out["lm_head"] = draw.normal((e, config.vocab_size), e ** -0.5)
        for i in range(config.num_layers):
            p = f"layers.{i}."
            out[p + "ln_attn"] = draw.ones(e)
            out[p + "ln_mlp"] = draw.ones(e)
            out.update(_attention_draws(draw, config, p + "attn."))
            out.update(_mlp_draws(draw, config, p))
        return out


class _Seq2SeqFamily(_Family):
    def model(self):
        from .seq2seq import Seq2SeqLM

        return Seq2SeqLM

    def stacks(self, config) -> list:
        enc = _histories(config, ("attn", _ATTN_HIST), ("", _MLP_HIST))
        dec = _histories(config, ("self_attn", _ATTN_HIST), ("cross_attn", _ATTN_HIST),
                         ("", _MLP_HIST))
        return [("encoder", "encoder/layers/block", config.num_layers, _DECODER_BLOCK + enc),
                ("decoder", "decoder/layers/block", config.num_decoder_layers,
                 _SEQ2SEQ_DECODER_BLOCK + dec)]

    def names(self, config, blocks: list) -> list:
        head = [] if config.tie_embeddings else ["lm_head"]
        return ["embedding", *head, "ln_enc", "ln_dec"] + blocks

    def random(self, config, draw: _Draws) -> dict:
        e, v = config.embed_dim, config.vocab_size
        out = {"embedding": draw.normal((v, e), 0.02)}
        if not config.tie_embeddings:
            out["lm_head"] = draw.normal((e, v), e ** -0.5)
        out["ln_enc"], out["ln_dec"] = draw.ones(e), draw.ones(e)
        for i in range(config.num_layers):
            p = f"encoder.{i}."
            out.update({p + "ln_attn": draw.ones(e), p + "ln_mlp": draw.ones(e)})
            out.update(_attention_draws(draw, config, p + "attn."))
            out.update(_mlp_draws(draw, config, p))
        for i in range(config.num_decoder_layers):
            p = f"decoder.{i}."
            out.update({p + n: draw.ones(e) for n in ("ln_self", "ln_cross", "ln_mlp")})
            out.update(_attention_draws(draw, config, p + "self_attn."))
            out.update(_attention_draws(draw, config, p + "cross_attn."))
            out.update(_mlp_draws(draw, config, p))
        return out


class _EncoderFamily(_Family):
    def model(self):
        from .encoder import EncoderClassifier

        return EncoderClassifier

    def stacks(self, config) -> list:
        return [("layers", None, config.num_layers, _ENCODER_BLOCK + _histories(
            config, ("", _ATTN_HIST + fp8.ENCODER_MLP_HISTORIES)))]

    def names(self, config, blocks: list) -> list:
        return list(_ENCODER_TOP) + blocks

    def random(self, config, draw: _Draws) -> dict:
        e, h, d, m = config.embed_dim, config.num_heads, config.head_dim, config.mlp_dim
        normal, ones, zeros, dt = draw.normal, draw.ones, draw.zeros, draw.dt
        out = {"word_embedding": normal((config.vocab_size, e), 0.02),
               "position_embedding": normal((config.max_seq_len, e), 0.02),
               "type_embedding": normal((config.type_vocab_size, e), 0.02),
               "ln_embed_scale": ones(e), "ln_embed_bias": zeros(e),
               "pooler_kernel": normal((e, e), e ** -0.5), "pooler_bias": zeros(e, dt),
               "classifier_kernel": normal((e, config.num_labels), e ** -0.5),
               "classifier_bias": zeros(config.num_labels, dt)}
        for i in range(config.num_layers):
            p = f"layers.{i}."
            out.update({p + "wq": normal((e, h, d), e ** -0.5),
                        p + "wk": normal((e, h, d), e ** -0.5),
                        p + "wv": normal((e, h, d), e ** -0.5),
                        p + "wo": normal((h, d, e), (h * d) ** -0.5)})
            for j in (1, 2):
                out[p + f"ln{j}_scale"] = ones(e)
                out[p + f"ln{j}_bias"] = zeros(e)
            out.update({p + "w_in": normal((e, m), e ** -0.5), p + "b_in": zeros(m, dt),
                        p + "w_out": normal((m, e), m ** -0.5), p + "b_out": zeros(e, dt)})
        return out


class _VisionFamily(_Family):
    """The ResNet: every weight under the reference's own name (dots for
    slashes), never stacked; the BatchNorm running averages are buffers,
    the reference's ``batch_stats`` collection (``BATCH_STATS``); conv
    kernels are OIHW in the port and HWIO in the reference."""

    def model(self):
        from .vision import ResNet

        return ResNet

    def names(self, config, blocks: list) -> list:
        return list(self.model()(config, device="meta").state_dict())

    def is_buffer(self, port_name: str) -> bool:
        return port_name.endswith((".mean", ".var"))

    def ref_name(self, port_name: str) -> str:
        path = port_name.replace(".", "/")
        return BATCH_STATS + path if self.is_buffer(port_name) else path

    def ref_leaves(self, leaves: dict) -> dict:
        # the reference's variables tree: its "params" collection unprefixed
        return {k[len("params/"):] if k.startswith("params/") else k: v
                for k, v in leaves.items()}

    def to_ref(self, x):
        if x.ndim != 4:
            return x
        return x.permute(2, 3, 1, 0) if isinstance(x, torch.Tensor) else x.transpose(2, 3, 1, 0)

    def from_ref(self, x):
        if x.ndim != 4:
            return x
        return x.permute(3, 2, 0, 1) if isinstance(x, torch.Tensor) else x.transpose(3, 2, 0, 1)

    def random(self, config, draw: _Draws) -> dict:
        """lecun-normal conv and classifier kernels (std fan_in ** -0.5,
        fan_in = kh * kw * cin or the classifier's inputs), BatchNorm
        scales 1 but each block's last (0, the reference's ``scale_init``),
        zero biases, running means 0 and variances 1. BatchNorm and
        classifier leaves in ``norm_dt``, conv kernels in ``dt``."""
        shapes = {k: t.shape for k, t in
                  self.model()(config, device="meta").state_dict().items()}
        norms = [k.rsplit(".", 1)[0] for k in shapes
                 if ".BatchNorm_" in k and k.endswith(".scale")]
        last_bn = {max(n for n in norms if n.split(".")[0] == block)
                   for block in {n.split(".")[0] for n in norms}}
        out = {}
        for name, shape in shapes.items():
            owner, leaf = name.rsplit(".", 1)
            if leaf == "kernel":
                fan_in = shape[1] * shape[2] * shape[3] if len(shape) == 4 else shape[0]
                w = draw.normal(shape, fan_in ** -0.5)
                out[name] = w if len(shape) == 4 else w.to(draw.norm_dt)
            elif leaf == "scale":
                out[name] = draw.zeros(shape) if owner in last_bn else draw.ones(shape)
            elif leaf == "var":
                out[name] = draw.ones(shape, torch.float32)
            elif leaf == "mean":
                out[name] = draw.zeros(shape, torch.float32)
            else:  # bias
                out[name] = draw.zeros(shape)
        return out


# in isinstance order: a subclass of a config is its family's
_FAMILIES = ((VisionConfig, _VisionFamily()), (Seq2SeqConfig, _Seq2SeqFamily()),
             (EncoderConfig, _EncoderFamily()), (DecoderConfig, _DecoderFamily()))


def _family(config) -> _Family:
    for kind, family in _FAMILIES:
        if isinstance(config, kind):
            return family
    raise TypeError(f"no port model for {type(config).__name__}")


def model_class(config):
    """The port's model of a config: ``DecoderLM``, ``Seq2SeqLM``,
    ``EncoderClassifier`` or ``ResNet``."""
    return _family(config).model()


def layout_config(model):
    """The config whose reference layout a model's weights take (a
    ``DecoderLM``, ``Seq2SeqLM``, ``EncoderClassifier`` or ``ResNet``),
    else None: any other module keeps its own names. A model pipelined
    over the mesh's ``stage`` axis lays its stack out as the reference's
    pipelined tree, as one with an explicit ``pipeline_stages``."""
    from .decoder import _Model

    if not isinstance(model, _Model):
        return None
    cfg = model.config
    stages = model.num_stages
    if stages > 1 and getattr(cfg, "pipeline_stages", 1) != stages:
        cfg = dataclasses.replace(cfg, pipeline_stages=stages)
    return cfg


# the reference's pipelined stack: ``pipeline/schedule/stages/layers/...``
# in place of ``layers/...`` (a seq2seq model's under ``decoder/``), its
# leaves [S, L / S, ...] (its parallel/pipeline.remap_params_to_pipeline)
PIPELINED = "pipeline/schedule/stages/layers/"


def _stages(config) -> int:
    return getattr(config, "pipeline_stages", 1) if isinstance(
        config, (DecoderConfig, Seq2SeqConfig)) else 1


def _unstaged(leaves: dict) -> dict:
    """A flat reference tree with any pipelined stack folded back into the
    layer stack: ``.../pipeline/schedule/stages/layers/x`` [S, L / S, ...]
    -> ``.../layers/x`` [L, ...] (views)."""
    out = {}
    for k, v in leaves.items():
        if PIPELINED in k:
            k = k.replace(PIPELINED, "layers/")
            v = v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
        out[k] = v
    return out


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
    family = _family(config)
    for prefix, ref_prefix, layers, _ in family.stacks(config):
        if port_name.startswith(prefix + "."):
            _, i, name = port_name.split(".", 2)
            path = name.replace(".", "/")
            # a block's buffers are its fp8 histories: the fp8_stats collection
            stats = FP8_STATS if family.is_buffer(port_name) else ""
            if ref_prefix is None:
                return f"{stats}layer_{i}/{path}", None, None
            return f"{stats}{ref_prefix}/{path}", int(i), layers
    return family.ref_name(port_name), None, None


def block_of(port_name: str, config):
    """(the block module that owns a weight, the weight's name in its
    block prefixed by the stack's): ``("encoder.3", "encoder.attn.wq")``;
    ``("", name)`` for a top-level weight."""
    for prefix, _, _, _ in _family(config).stacks(config):
        if port_name.startswith(prefix + "."):
            _, i, name = port_name.split(".", 2)
            return f"{prefix}.{i}", f"{prefix}.{name}"
    return "", port_name


def port_names(config) -> list:
    """The port's weight names of a family, block weights in layer
    order."""
    family = _family(config)
    blocks = [f"{prefix}.{i}.{n}" for prefix, _, layers, leaves in family.stacks(config)
              for i in range(layers) for n in leaves]
    return family.names(config, blocks)


def reference_layout(config, weights: Mapping) -> dict:
    """``{reference flat name: (port names, shape)}`` in the reference's
    tree order, for ``weights`` keyed by the port's names (anything with a
    ``shape``: tensors, meta tensors, numpy arrays). A block leaf stacked
    along the layer axis lists its layers' names
    in layer order under the shape [L, ...]; any other leaf has one name
    and that weight's shape in the reference's layout. A buffer
    ``weights`` lacks (optimizer moments) is left out."""
    family = _family(config)
    groups: dict = {}
    for name in port_names(config):
        if family.is_buffer(name) and name not in weights:
            continue
        ref, i, _ = locate(name, config)
        groups.setdefault(ref, ([], i is not None))[0].append(name)
    stages = _stages(config)
    # the pipelined stack: the decoder's blocks, a seq2seq's decoder tower
    piped = "decoder/layers/" if isinstance(config, Seq2SeqConfig) else "layers/"
    out = {}
    for ref, (names, stacked) in groups.items():
        shape = tuple(family.to_ref(weights[names[0]]).shape)
        if stacked and stages > 1 and piped in ref:
            ref = ref.replace(piped, piped[:-len("layers/")] + PIPELINED)
            out[ref] = (names, (stages, len(names) // stages) + shape)
        else:
            out[ref] = (names, (len(names),) + shape if stacked else shape)
    return {ref: out[ref] for ref in sorted(out, key=lambda k: k.split("/"))}


def _layer(leaf, i: int):
    """Row ``i`` of a stacked leaf, without a copy."""
    return leaf.layer(i) if hasattr(leaf, "layer") else leaf[i]


def from_reference(params, config, dtype: Optional[torch.dtype] = None) -> dict:
    """The reference model's parameter tree -> the port's weight dict, for
    any of the four families (``config`` says which). ``params`` is the
    unboxed nested tree (leaves numpy, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) or a flat dict under
    the reference's checkpoint names; leaves may be numpy arrays, tensors
    or QuantizedWeights. A decoder's stacked tree (``scan_layers=True``:
    every block leaf under ``layers/block/...`` with a leading layer axis)
    and unrolled one (``layer_{i}/...``) are both accepted; stacked leaves
    give per-layer views. A ResNet's is the reference's variables tree
    (``{"params": ..., "batch_stats": ...}``, e.g. ``init_variables``'),
    or its params alone for a dict of parameters only: a buffer the tree
    lacks is left out. With ``dtype``, numpy and tensor leaves become CPU
    tensors of it (``torch.float32`` for training's master weights)."""
    family = _family(config)
    leaves = _unstaged(family.ref_leaves(reference_leaves(params)))
    cfg = config
    if isinstance(config, DecoderConfig):
        stacked = any(k.startswith("layers/") for k in leaves)
        cfg = dataclasses.replace(config, scan_layers=stacked)
    out = {}
    for name in port_names(cfg):
        ref, i, layers = locate(name, cfg)
        if family.is_buffer(name) and ref not in leaves:
            continue
        leaf = leaves[ref]
        if not isinstance(leaf, torch.Tensor) and not hasattr(leaf, "layer"):
            leaf = np.asarray(leaf)  # numpy (or JAX) arrays
        if i is not None:
            if leaf.shape[0] != layers:
                raise ValueError(f"{ref} stacks {leaf.shape[0]} layers, config has {layers}")
            leaf = _layer(leaf, i)
        out[name] = family.from_ref(leaf)
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

    to_ref = _family(config).to_ref
    layout = reference_layout(_stacked(config), weights)  # staged by pipeline_stages
    return unflatten_to_like({ref: np.stack([arr(to_ref(weights[n]))
                                             for n in names]).reshape(shape)
                              for ref, (names, shape) in layout.items()})


def reference_entries(weights: Mapping, config, prefix: str = "",
                      dtype: Optional[torch.dtype] = None,
                      buffer_prefix: Optional[str] = None) -> list:
    """The port's weight dict (tensors on any device, or anything keyed
    alike: gradients, Adam moments) as ``(prefix + reference name, shape,
    dtype, fetch)`` entries of ``utils/serialization.save_entries``, in
    the reference's tree order, block leaves stacked along the layer axis
    or unrolled as the reference lays them out. ``fetch`` yields a stacked
    leaf's layer slices one at a time, so a writer holds one slice on the
    host, not the stack. A sharded weight (a DTensor) is gathered whole
    when its slice is fetched, one at a time: a collective, so every rank
    fetches every entry in the same order. ``dtype`` None keeps each
    leaf's own. A buffer (a ResNet's ``batch_stats/...``) goes under
    ``buffer_prefix`` when one is given, else under ``prefix``."""
    family = _family(config)
    out = []
    shapes = {n: torch.empty(tuple(w.shape), dtype=w.dtype, device="meta")
              if _is_dtensor(w) else w for n, w in weights.items()}
    for ref, (names, shape) in reference_layout(config, shapes).items():
        dt = dtype or weights[names[0]].dtype
        key = (buffer_prefix if buffer_prefix is not None and family.is_buffer(names[0])
               else prefix) + ref
        out.append((key, shape, dt,
                    (lambda ns, dt: lambda: (family.to_ref(whole(weights[n].detach().to(dt)))
                                             for n in ns))(names, dt)))
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
# optax.sgd(schedule, momentum) is chain(trace, scale_by_learning_rate):
# the momentum trace under "0/trace/" (none without momentum) and a
# schedule's count under "1/"
TRACE, SGD_SCHEDULE_COUNT = "0/trace/", "1/count"


def _moment_layout(model):
    """(parameters by name, config or None): a port model maps through the
    reference's layout, any other module keeps its own names."""
    params = dict(model.named_parameters())
    config = layout_config(model) if hasattr(model, "config") else None
    if config is None:
        config = getattr(model, "config", None)
    return params, (config if isinstance(config, CONFIGS) else None)


def sgd_has_optax_state(optimizer) -> bool:
    """True when a torch ``SGD``'s momentum buffers are ``optax.sgd``'s
    trace: no group dampens it. Weight decay and nesterov keep the trace's
    form (decay is added to the gradient before it; nesterov reads it
    after), so they are hyperparameters, as AdamW's are."""
    return not any(group.get("dampening") for group in optimizer.param_groups)


def _optax_kind(optimizer) -> str:
    """"adamw" for a torch ``AdamW`` (optax.adamw's state), "sgd" for a
    torch ``SGD`` (optax.sgd's); raises on anything else, and on options
    optax's counterpart has no state or rule for."""
    if isinstance(optimizer, torch.optim.AdamW):
        if any(group.get("amsgrad") for group in optimizer.param_groups):
            raise NotImplementedError("optax.adamw has no amsgrad state")
        return "adamw"
    if isinstance(optimizer, torch.optim.SGD):
        if not sgd_has_optax_state(optimizer):
            raise NotImplementedError("optax.sgd's trace has no dampening")
        return "sgd"
    raise TypeError(f"optax.adamw's and optax.sgd's states map to torch.optim.AdamW's and "
                    f"SGD's, not {type(optimizer).__name__}'s")


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
    A torch ``SGD``'s as ``optax.sgd``'s: ``0/trace/<name>`` (each
    ``momentum_buffer``, fp32; none without momentum) and ``1/count``
    under a ``LambdaLR``.
    For a port model the names and the layout are the reference's
    weights' (:func:`reference_entries`: a stacked moment is
    fetched a layer slice at a time); any other module's moments keep
    its parameter names and have no reference counterpart. A parameter
    the optimizer has not updated yet has zero moments, as optax's
    initial state. betas, eps and weight decay are hyperparameters: no
    optax state holds them."""
    kind = _optax_kind(optimizer)
    params, config = _moment_layout(model)

    def scalar(value):
        return (torch.Size(()), torch.int32,
                (lambda v: lambda: torch.tensor(v, dtype=torch.int32))(int(value)))

    def moment_entries(prefix, m):
        if config is not None:
            return reference_entries(m, config, prefix=prefix, dtype=torch.float32)
        return [(prefix + n, tuple(t.shape), torch.float32,
                 (lambda t: lambda: whole(t).detach().float())(t)) for n, t in m.items()]

    def moments(key):
        # a sharded moment stays sharded: its entry gathers it when fetched
        out = {}
        for n, p in params.items():
            t = optimizer.state.get(p, {}).get(key)
            if t is None:  # a zero of the parameter's shape that allocates nothing
                t = torch.zeros((), dtype=torch.float32, device=p.device).expand(tuple(p.shape))
            out[n] = t
        from ..parallel.pipeline import every_stage

        return every_stage(model, out)

    sched = _lambda_schedule(scheduler)
    if kind == "sgd":
        entries = []
        if any(group["momentum"] for group in optimizer.param_groups):
            entries += moment_entries(TRACE, moments("momentum_buffer"))
        if sched is not None:
            entries.append((SGD_SCHEDULE_COUNT, *scalar(sched.last_epoch)))
        return entries
    counts = {int(optimizer.state[p]["step"]) for p in params.values()
              if "step" in optimizer.state.get(p, {})}
    if len(counts) > 1:
        raise ValueError(f"the parameters' update counts differ ({sorted(counts)}): "
                         "optax keeps one count")
    count = counts.pop() if counts else 0
    entries = [(ADAM_COUNT, *scalar(count))]
    for prefix, key in ((MU, "exp_avg"), (NU, "exp_avg_sq")):
        entries += moment_entries(prefix, moments(key))
    if sched is not None:
        entries.append((SCHEDULE_COUNT, *scalar(sched.last_epoch)))
    return entries


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def whole(t):
    """``t`` whole: a sharded tensor (a DTensor) gathered from every rank
    of its mesh (a collective), a block's tensor on a stage mesh
    (``parallel/pipeline.StageTensor``) broadcast from the rank that holds
    it, any other tensor as it is."""
    if hasattr(t, "fetch_whole"):
        return t.fetch_whole()
    return t.full_tensor() if _is_dtensor(t) else t


def _like_param(src: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``src`` (the whole tensor) as a new tensor laid out like ``p``: its
    device and dtype, and for a sharded parameter (``parallel/sharding``)
    this rank's shard of it, placed as ``p`` is."""
    if _is_dtensor(p):
        from torch.distributed.tensor import distribute_tensor

        # every rank holds the whole: each keeps its own shard, no scatter
        return distribute_tensor(src.to(p.device, p.dtype), p.device_mesh, p.placements,
                                 src_data_rank=None)
    return torch.empty_like(p, memory_format=torch.contiguous_format).copy_(src)


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
    decay it was built with (optax's state holds none). ``optax.sgd``'s
    into a torch ``SGD`` alike: ``0/trace/`` into each
    ``momentum_buffer``, ``1/count`` into the schedule."""
    kind = _optax_kind(optimizer)
    params, config = _moment_layout(model)
    slots = ((TRACE, "momentum_buffer"),) if kind == "sgd" else \
        ((MU, "exp_avg"), (NU, "exp_avg_sq"))
    if kind == "sgd" and not any(k.startswith(TRACE) for k in flat):
        slots = ()  # no momentum: optax.sgd keeps no trace
    views = {}
    for prefix, _ in slots:
        tree = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        views[prefix] = (from_reference(tree, config) if config is not None
                         else {n: tree[n] for n in params})
    group_of = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    for name, p in params.items():
        state = {}
        if kind == "adamw":
            state["step"] = _step_tensor(optimizer, group_of[id(p)], p, int(flat[ADAM_COUNT]))
        for prefix, key in slots:
            src = views[prefix][name]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{prefix}{name}: shape {tuple(src.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            state[key] = _like_param(src, p)
        optimizer.state[p] = state
    sched = _lambda_schedule(scheduler)
    count_key = SGD_SCHEDULE_COUNT if kind == "sgd" else SCHEDULE_COUNT
    if sched is not None and count_key in flat:
        steps = int(flat[count_key])
        sched.last_epoch = steps
        sched._step_count = steps + 1
        for group, base, fn in zip(optimizer.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(steps)
        sched._last_lr = [group["lr"] for group in optimizer.param_groups]


def random_params(config, seed: int = 0, device: Optional[torch.device] = None,
                  dtype: Optional[torch.dtype] = None) -> dict:
    """Seeded random weights of any of the four families, made on
    ``device`` (``None`` means CUDA; raises without it unless
    ``device="cpu"``): normal(0.02) embeddings, fan-in scaled normal
    matmul weights (the reference's initializers), unit norm scales, zero
    norm and linear biases (a ResNet's: ``_VisionFamily.random``). ``dtype``
    None gives matmul weights, biases and embeddings in the compute dtype
    and fp32 norms (serving); a dtype gives every weight in it
    (``torch.float32`` for training's master weights)."""
    from .decoder import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return _family(config).random(config, _Draws(gen, dev, dtype or config.dtype,
                                                 dtype or torch.float32))
