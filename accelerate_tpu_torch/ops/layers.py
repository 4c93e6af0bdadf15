"""Elementwise building blocks: RMSNorm, SwiGLU and split-half RoPE.

Counterpart of ``accelerate_tpu/ops/layers.py``. Norm and RoPE math runs
in fp32 and casts back to the input dtype, as the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 internal math, output in x.dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU activation: silu(gate) * up."""
    return F.silu(gate) * up


def rotary_embedding_tables(
    positions: torch.Tensor,
    head_dim: int,
    *,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for RoPE; positions [..., S] -> [..., S, head_dim/2]."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # a device fill, not a copy of a host scalar: a CUDA graph captures this
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / torch.pow(base, exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def apply_rotary_embedding(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
) -> torch.Tensor:
    """Rotate pairs (split-half convention). x: [B, H, S, D]; sin/cos
    [S, D/2] or [B, S, D/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if sin.dim() == 2:  # [S, half] -> broadcast over batch + heads
        sin_b, cos_b = sin[None, None].float(), cos[None, None].float()
    else:  # [B, S, half] -> broadcast over heads
        sin_b, cos_b = sin[:, None].float(), cos[:, None].float()
    r1 = x1 * cos_b - x2 * sin_b
    r2 = x2 * cos_b + x1 * sin_b
    return torch.cat([r1, r2], dim=-1).to(x.dtype)
