"""KV-cache quantization: the int8/int4 storage of the KV cache.

The port's own copy of the KV part of ``accelerate_tpu/utils/quantization.py``
(the weight-quantization part belongs to a later slice). Every expression
is the reference's, so payloads and scales agree bit for bit:

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

import torch

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
