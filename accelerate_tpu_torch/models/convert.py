"""Weights for the port's ``DecoderLM``: conversion from and to the
reference's parameter tree, and a seeded random init on the device.

The port's weights are a flat dict keyed like ``DecoderLM.state_dict()``
(``embedding``, ``ln_final``, ``lm_head`` when untied, and
``layers.{i}.ln_attn`` / ``ln_mlp`` / ``attn.wq`` ... / ``mlp.w_down``),
with the reference's leaf layouts: ``wq [E, H, D]``, ``wk``/``wv
[E, KVH, D]``, ``wo [H, D, E]``, ``w_gate``/``w_up [E, M]``,
``w_down [M, E]``, ``embedding [V, E]``, ``lm_head [E, V]``.
Load them with :meth:`DecoderLM.load_params`. :func:`to_reference` turns
such a dict (weights, or gradients keyed alike) back into the reference's
scan-stacked tree, so tests compare the two leaf by leaf.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def from_reference(params, config: DecoderConfig, dtype: Optional[torch.dtype] = None) -> dict:
    """The reference ``DecoderLM``'s unboxed parameter tree (leaves already
    numpy, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) -> the
    port's weight dict: numpy arrays, or CPU tensors of ``dtype`` when
    one is given (``torch.float32`` for training's master weights).

    Scan-stacked trees (``scan_layers=True``) keep every block leaf under
    ``layers/block/...`` with a leading layer axis; unrolled trees name
    each block ``layer_{i}``. Both are accepted."""
    out = {
        "embedding": np.asarray(params["embedding"]),
        "ln_final": np.asarray(params["ln_final"]),
    }
    if not config.tie_embeddings:
        out["lm_head"] = np.asarray(params["lm_head"])
    stacked = "layers" in params
    for name, path in _BLOCK_LEAVES.items():
        if stacked:
            leaf = _leaf(params["layers"]["block"], path)
            if leaf.shape[0] != config.num_layers:
                raise ValueError(
                    f"layers/block/{'/'.join(path)} stacks {leaf.shape[0]} "
                    f"layers, config has {config.num_layers}"
                )
            for i in range(config.num_layers):
                out[f"layers.{i}.{name}"] = leaf[i]
        else:
            for i in range(config.num_layers):
                out[f"layers.{i}.{name}"] = _leaf(params[f"layer_{i}"], path)
    if dtype is not None:
        out = {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in out.items()}
    return out


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

    out = {"embedding": arr(weights["embedding"]), "ln_final": arr(weights["ln_final"])}
    if not config.tie_embeddings:
        out["lm_head"] = arr(weights["lm_head"])
    block = {}
    for name, path in _BLOCK_LEAVES.items():
        node = block
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(
            [arr(weights[f"layers.{i}.{name}"]) for i in range(config.num_layers)])
    out["layers"] = {"block": block}
    return out


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
