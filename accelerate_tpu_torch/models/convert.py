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


def export_reference_checkpoint(weights: dict, config: DecoderConfig, path,
                                dtype: torch.dtype = torch.bfloat16,
                                max_shard_size: Optional[int] = None) -> list:
    """Write the port's weight dict (tensors, on any device) as the
    reference's checkpoint of ``dtype`` at ``path``: its flat names in its
    tree order, block leaves stacked along the layer axis
    (``config.scan_layers``) or unrolled, sharded with an index when
    ``max_shard_size`` is given. A stacked leaf is written one layer slice
    at a time, so the host holds one slice, not the stack. Returns the
    files written."""
    entries = [(ref, shape, dtype,
                (lambda ns: lambda: (weights[n].detach().to(dtype) for n in ns))(names))
               for ref, (names, shape) in reference_layout(config, weights).items()]
    return save_entries(entries, path, max_shard_size)


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
