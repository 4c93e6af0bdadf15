"""Quantization: weights (int8 / int4 / NF4 on load, dequantized at use)
and the int8/int4 storage of the KV cache.

The port's own copy of ``accelerate_tpu/utils/quantization.py``.

**Weights.** Symmetric per-group quantization along dim 0 of a [K, ...]
leaf, in groups of ``group_size`` rows when that divides K, else one
group of all K rows. Linear codes store ``round(w * (1 / scale))`` with
``scale = amax / qmax``; NF4 stores the index of the nearest NormalFloat4
level with ``scale = amax``. 4 bits pack two rows a byte along dim 0
(row 2i the low nibble, row 2i + 1 the high one; linear nibbles are
signed, NF4 nibbles unsigned). With ``double_quant`` the fp32 scales are
quantized again, int8 over 256-scale blocks in the log domain.
Quantization is a host transform (:func:`quantize_array_host`): numpy,
with the reference's expressions, so data and scales agree with the
reference bit for bit, or the native helper (``runtime/native.py``),
which computes the same bits; a shape rule picks between them.
Dequantization (:func:`dequantize_array`) is plain torch on the device
the packed tensors live on, at use.

A leaf stacked along the layer axis (the reference's ``scan_layers``
tree: ``layers/block/mlp/w_up`` [32, 4096, 11008]) quantizes along that
axis, as the reference does: with 32 layers and ``group_size`` 128 there
is one group, one fp32 scale per column shared by all layers, and int4
packs layer pairs into a byte. :meth:`QuantizedWeight.layer` is layer i
of such a leaf: data row i (int8) or a nibble of byte row i // 2 (int4),
and scale row i // group; its dequantization equals row i of the whole
leaf's bit for bit. Each layer reads the whole shared scale row, 4 bytes
per element of one layer.

**KV cache.** Every expression is the reference's, so payloads and
scales agree bit for bit:

- the scale is ``amax / qmax`` per (token, kv head) over head_dim, 1.0
  for an all-zero row, a true division on every device;
- values are ``round(x * (1 / scale))``: a multiply by the reciprocal,
  not a division, which can round differently at .5;
- ``torch.round`` rounds half to even, as ``jnp.round`` does;
- clipping is to +-qmax (7 for int4, never -8);
- int4 packs two values a byte along head_dim, even indices in the low
  nibble, and unpacks with the sign extension ``(payload << 4) >> 4`` on
  int8 (torch's int8 shifts wrap, as JAX's do).

:func:`dequantize_kv` computes ``payload.float() * scale`` and rounds
once to the compute dtype: that rounding site is what the quantized
decode kernels (``csrc/decode_common.cuh``) copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

# NormalFloat4 code (QLoRA, Dettmers et al. 2023): 16 asymmetric levels,
# the quantiles of N(0, 1) normalized to [-1, 1], with an exact zero
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.4407098591327667, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    np.float32,
)
_NF4_MIDPOINTS = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2
_DOUBLE_QUANT_BLOCK = 256  # scales per second-level block


@dataclass
class QuantizationConfig:
    """Weight quantization on load (the reference's, with its defaults
    and checks). ``skip_modules``: path substrings never quantized
    (embeddings and heads by default); ``min_dims``: leaves of fewer dims
    are never quantized; ``quant_type`` ("linear" or "nf4") and
    ``double_quant`` apply to 4 bits only."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    group_size: int = 128
    skip_modules: Optional[list] = None
    min_dims: int = 2
    quant_type: str = "linear"
    double_quant: bool = False

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("pick one of load_in_8bit / load_in_4bit")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("QuantizationConfig with neither 8bit nor 4bit enabled")
        if self.quant_type not in ("linear", "nf4"):
            raise ValueError(f"quant_type must be 'linear' or 'nf4', got {self.quant_type!r}")
        if self.quant_type == "nf4" and not self.load_in_4bit:
            raise ValueError("nf4 is a 4-bit code; set load_in_4bit=True")
        if self.double_quant and not self.load_in_4bit:
            raise ValueError("double_quant applies to 4-bit quantization only")
        if self.skip_modules is None:
            self.skip_modules = ["embedding", "lm_head", "embed", "classifier", "pooler"]

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4


def _move(t, device, non_blocking):
    return t.to(device, non_blocking=non_blocking)


class QuantizedScale:
    """Double-quantized per-group scales: ``data`` int8 (the log scales
    less their mean, over flat blocks of 256), ``scale2`` fp32 per block,
    ``offset`` the fp32 mean (0-dim); ``shape`` the scales' own shape.
    Children ``0``, ``1``, ``2`` in a flattened tree."""

    def __init__(self, data, scale2, offset, shape):
        self.data = data
        self.scale2 = scale2
        self.offset = offset
        self.shape = tuple(shape)

    def tree_children(self):
        return (self.data, self.scale2, self.offset)

    def tree_rebuild(self, children):
        return QuantizedScale(*children, self.shape)

    def to(self, device, non_blocking: bool = False) -> "QuantizedScale":
        return self.tree_rebuild([_move(c, device, non_blocking) for c in self.tree_children()])

    def __repr__(self):
        return f"QuantizedScale(shape={self.shape})"


class QuantizedWeight:
    """A quantized leaf: ``data`` int8 ([K, ...]; 4 bits pack two rows a
    byte, [(K + 1) / 2, ...]) and ``scale`` fp32 [K / group, ...] or a
    :class:`QuantizedScale`. ``shape``, ``bits``, ``group``, ``dtype`` (the
    leaf's own, which dequantization returns) and ``qtype`` ("linear" or
    "nf4") describe it. Children ``0`` (data) and ``1`` (scale)."""

    def __init__(self, data, scale, shape, bits, group, dtype, qtype="linear"):
        self.data = data
        self.scale = scale
        self.shape = tuple(shape)
        self.bits = int(bits)
        self.group = int(group)
        self.dtype = dtype
        self.qtype = qtype

    def tree_children(self):
        return (self.data, self.scale)

    def tree_rebuild(self, children):
        return QuantizedWeight(children[0], children[1], self.shape, self.bits, self.group,
                               self.dtype, self.qtype)

    def to(self, device, non_blocking: bool = False) -> "QuantizedWeight":
        return self.tree_rebuild([_move(c, device, non_blocking) for c in self.tree_children()])

    def layer(self, i: int) -> "QuantizedLayer":
        """Layer ``i`` of a leaf stacked along dim 0, dequantized at use."""
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"layer {i} of a leaf stacking {self.shape[0]}")
        return QuantizedLayer(self, i)

    def __repr__(self):
        return (f"QuantizedWeight(shape={self.shape}, bits={self.bits}, "
                f"group={self.group}, qtype={self.qtype})")


class QuantizedLayer:
    """Layer ``i`` of a stacked :class:`QuantizedWeight`, or the whole
    weight for ``i`` None. :meth:`weight` dequantizes it on ``device``
    (the data's own when None), moving packed tensors that live elsewhere
    (pinned host memory) there first with asynchronous copies. ``code`` is
    the NF4 table on that device (made per call when None)."""

    def __init__(self, qw: QuantizedWeight, i: Optional[int] = None, device=None, code=None):
        self.qw, self.i, self.device, self.code = qw, i, device, code

    def weight(self) -> torch.Tensor:
        qw = self.qw
        dev = self.device if self.device is not None else qw.data.device
        if self.i is None:
            return dequantize_array(qw.to(dev, non_blocking=True), self.code)
        scale = _scale_values(qw.scale, dev)[self.i // qw.group]
        if qw.bits == 4:
            lo, hi = _nibbles(qw.data[self.i // 2].to(dev, non_blocking=True), qw.qtype)
            data = hi if self.i % 2 else lo
        else:
            data = qw.data[self.i].to(dev, non_blocking=True)
        return (_values(data, qw.qtype, self.code) * scale).to(qw.dtype)


def quantize_array_host(w, bits: int = 8, group_size: int = 128, qtype: str = "linear",
                        double_quant: bool = False) -> QuantizedWeight:
    """Quantize a [K, ...] float tensor on the host along dim 0 (groups of
    ``group_size`` rows when that divides K, else one group). The native
    helper quantizes when its shape rule allows it
    (``runtime/native.native_quantize_supported``), else the plain
    version; both give the reference's bits. Returns CPU tensors."""
    from ..runtime.native import native_quantize_supported, quantize_group_native

    if qtype == "nf4" and bits != 4:
        raise ValueError("nf4 is a 4-bit code")
    w = torch.as_tensor(w).detach().to("cpu")
    k = w.shape[0]
    g = group_size if (group_size > 0 and k % group_size == 0) else k
    if native_quantize_supported(tuple(w.shape), g, bits, w.dtype):
        q, scale = quantize_group_native(w, g, bits, qtype == "nf4")
    else:
        q, scale = _quantize_plain(w, g, bits, qtype == "nf4")
    if double_quant:
        scale = _quantize_scales_host(scale)
    return QuantizedWeight(q, scale, tuple(w.shape), bits, g, w.dtype, qtype)


def _quantize_plain(w: torch.Tensor, g: int, bits: int, nf4: bool):
    """The plain version: the reference's numpy expressions on the leaf
    widened to fp32. Returns (data, scale) CPU tensors."""
    shape = tuple(w.shape)
    k = shape[0]
    w32 = w.float().numpy().reshape(k // g, g, *shape[1:])
    amax = np.max(np.abs(w32), axis=1, keepdims=True)
    if nf4:
        scale = np.where(amax > 0, amax, 1.0).astype(np.float32)
        normed = w32 * (np.float32(1.0) / scale)
        q = np.searchsorted(_NF4_MIDPOINTS, normed).astype(np.int8)
    else:
        qmax = float(2 ** (bits - 1) - 1)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        q = np.clip(np.round(w32 * (np.float32(1.0) / scale)), -qmax, qmax).astype(np.int8)
    q = q.reshape(shape)
    scale = scale[:, 0]
    if bits == 4:
        if k % 2:
            q = np.concatenate([q, np.zeros((1,) + q.shape[1:], q.dtype)], axis=0)
        q = ((q[0::2] & 0x0F) | ((q[1::2] & 0x0F) << 4)).astype(np.int8)
    return torch.from_numpy(np.ascontiguousarray(q)), torch.from_numpy(np.ascontiguousarray(scale))


def _quantize_scales_host(scale: torch.Tensor) -> QuantizedScale:
    """Second-level quantization of the fp32 scales in the log domain: the
    log scales less their mean, int8 over blocks of 256 with an fp32
    absmax scale each (the reference's numpy expressions)."""
    shape = tuple(scale.shape)
    flat = np.log(np.maximum(scale.numpy().reshape(-1).astype(np.float32), 1e-30))
    offset = np.float32(flat.mean())
    centered = flat - offset
    n = flat.size
    nblocks = max(1, -(-n // _DOUBLE_QUANT_BLOCK))
    pad = nblocks * _DOUBLE_QUANT_BLOCK - n
    if pad:
        centered = np.concatenate([centered, np.zeros(pad, np.float32)])
    blocks = centered.reshape(nblocks, _DOUBLE_QUANT_BLOCK)
    amax = np.abs(blocks).max(axis=1, keepdims=True)
    scale2 = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q8 = np.clip(np.round(blocks / scale2), -127, 127).astype(np.int8)
    return QuantizedScale(torch.from_numpy(np.ascontiguousarray(q8.reshape(-1)[:n].reshape(shape))),
                          torch.from_numpy(np.ascontiguousarray(scale2[:, 0])),
                          torch.tensor(offset), shape)


def _dequantize_scales(qs: QuantizedScale) -> torch.Tensor:
    """The inverse of :func:`_quantize_scales_host`, in torch on the
    scales' device."""
    n = int(np.prod(qs.shape)) if qs.shape else 1
    flat = qs.data.reshape(-1).float()
    nblocks = qs.scale2.shape[0]
    pad = nblocks * _DOUBLE_QUANT_BLOCK - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(nblocks, _DOUBLE_QUANT_BLOCK) * qs.scale2[:, None]
    return torch.exp(blocks.reshape(-1)[:n] + qs.offset).reshape(qs.shape)


def _scale_values(scale, device) -> torch.Tensor:
    """fp32 scales on ``device`` (dequantized when double-quantized)."""
    scale = scale.to(device, non_blocking=True)
    return _dequantize_scales(scale) if isinstance(scale, QuantizedScale) else scale


def _nibbles(data: torch.Tensor, qtype: str):
    """(low, high) nibbles of packed int4 bytes: code indices 0..15 for
    NF4, sign-extended values for the linear code."""
    if qtype == "nf4":
        return data & 0x0F, (data >> 4) & 0x0F
    return (data << 4) >> 4, data >> 4


def _values(data: torch.Tensor, qtype: str, code=None) -> torch.Tensor:
    """Stored integers as fp32 values: NF4 levels, or the integers."""
    if qtype != "nf4":
        return data.float()
    if code is None:
        code = torch.from_numpy(NF4_CODE).to(data.device)
    return code[data.long()]


def dequantize_array(qw: QuantizedWeight, code=None) -> torch.Tensor:
    """The leaf back in its own dtype, on the device of its packed
    tensors: ``values * scale`` in fp32, rounded once."""
    data = qw.data
    k, g = qw.shape[0], qw.group
    if qw.bits == 4:
        lo, hi = _nibbles(data, qw.qtype)
        data = torch.stack([lo, hi], dim=1).reshape(2 * data.shape[0], *qw.shape[1:])[:k]
    w = _values(data, qw.qtype, code)
    w = w.reshape(k // g, g, *qw.shape[1:]) * _scale_values(qw.scale, data.device)[:, None]
    return w.reshape(qw.shape).to(qw.dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def quantize_abstract(leaf, config: QuantizationConfig) -> QuantizedWeight:
    """What an eligible leaf (a tensor, or a meta tensor for its shape and
    dtype) becomes on load, as meta tensors: the shapes for budgeting."""
    shape = tuple(leaf.shape)
    k = shape[0]
    g = config.group_size if (config.group_size > 0 and k % config.group_size == 0) else k
    data_shape = ((k + 1) // 2,) + shape[1:] if config.bits == 4 else shape
    scale_shape = (k // g,) + shape[1:]
    scale = _meta(scale_shape, torch.float32)
    if config.double_quant:
        n = int(np.prod(scale_shape)) if scale_shape else 1
        nblocks = max(1, -(-n // _DOUBLE_QUANT_BLOCK))
        scale = QuantizedScale(_meta(scale_shape, torch.int8), _meta((nblocks,), torch.float32),
                               _meta((), torch.float32), scale_shape)
    return QuantizedWeight(_meta(data_shape, torch.int8), scale, shape, config.bits, g,
                           leaf.dtype, config.quant_type)


def quantize_abstract_tree(abstract_params, config: QuantizationConfig):
    """``abstract_params`` with every eligible leaf replaced by its
    :func:`quantize_abstract` shadow: the packed sizes a device map
    budgets."""
    from .serialization import flatten_pytree, unflatten_to_like

    out = {path: quantize_abstract(leaf, config) if _eligible(path, leaf, config) else leaf
           for path, leaf in flatten_pytree(abstract_params).items()}
    return unflatten_to_like(out, abstract_params)


def _is_floating(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(np.dtype(dtype), np.floating)


def _eligible(path: str, leaf, config: QuantizationConfig) -> bool:
    """Whether a leaf quantizes: at least ``min_dims`` dims, floating, and
    no ``skip_modules`` substring in its path."""
    if len(getattr(leaf, "shape", ())) < config.min_dims or not hasattr(leaf, "dtype"):
        return False
    if not _is_floating(leaf.dtype):
        return False
    lowered = path.lower()
    return not any(skip in lowered for skip in config.skip_modules)


def _map_quantized(tree, fn):
    """``tree`` with ``fn`` applied to every QuantizedWeight node."""
    if isinstance(tree, QuantizedWeight):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_quantized(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_quantized(v, fn) for v in tree)
    return tree


def quantize_params(params, config: QuantizationConfig):
    """Every eligible leaf of a tree quantized on the host; the packed
    tensors go back to the leaf's device."""
    from .serialization import flatten_pytree, unflatten_to_like

    out = {}
    for path, leaf in flatten_pytree(params).items():
        if _eligible(path, leaf, config):
            leaf = quantize_array_host(
                leaf, bits=config.bits, group_size=config.group_size,
                qtype=config.quant_type, double_quant=config.double_quant,
            ).to(leaf.device)
        out[path] = leaf
    return unflatten_to_like(out, params)


def dequantize_params(params):
    """Every QuantizedWeight of a tree replaced by its dequantized tensor."""
    return _map_quantized(params, dequantize_array)


def quantized_nbytes(params) -> int:
    """Bytes of a (possibly quantized) tree's tensors."""
    from .serialization import flatten_pytree

    return sum(int(np.prod(leaf.shape)) * leaf.element_size()
               for leaf in flatten_pytree(params).values() if hasattr(leaf, "element_size"))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

KV_CACHE_DTYPES = ("bf16", "int8", "int4")


def kv_cache_bits(kv_dtype) -> int:
    """Storage bits per K/V value for a ``kv_cache_dtype`` value (None or
    "bf16" -> 16). Raises on unknown values."""
    if kv_dtype in (None, "bf16"):
        return 16
    if kv_dtype == "int8":
        return 8
    if kv_dtype == "int4":
        return 4
    raise ValueError(
        f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, got {kv_dtype!r}"
    )


def quantize_kv(x: torch.Tensor, bits: int):
    """Symmetric quantization along the last axis (head_dim): ``x [..., D]``
    -> ``(payload int8 [..., D] (int8) or [..., D // 2] (int4), scale fp32
    [..., 1])`` with ``x ~= payload * scale``. Zero rows give payload 0
    and scale 1.0."""
    if bits not in (8, 4):
        raise ValueError(f"KV quantization supports 8 or 4 bits, got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch turns a division by a Python scalar on
    # CUDA into a product with its reciprocal, which is not amax / qmax
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 * (1.0 / scale)), -qmax, qmax).to(torch.int8)
    if bits == 4:
        if x.shape[-1] % 2:
            raise ValueError(f"int4 KV packing needs an even head_dim, got {x.shape[-1]}")
        lo = q[..., 0::2] & 0x0F
        hi = (q[..., 1::2] & 0x0F) << 4
        q = lo | hi
    return q, scale


def unpack_int4_kv(payload: torch.Tensor) -> torch.Tensor:
    """[..., D // 2] packed nibbles -> [..., D] signed int8 values (even
    head_dim indices from the low nibble, odd from the high)."""
    lo = (payload << 4) >> 4  # sign-extend the low nibble
    hi = payload >> 4          # arithmetic shift
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*payload.shape[:-1], 2 * payload.shape[-1])


def dequantize_kv(payload: torch.Tensor, scale: torch.Tensor, bits: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``payload.float() * scale`` rounded once to ``dtype``: the plain
    version of the quantized decode kernel's staging step."""
    if bits == 4:
        payload = unpack_int4_kv(payload)
    return (payload.float() * scale).to(dtype)
