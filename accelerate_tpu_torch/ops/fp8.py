"""fp8 projections: e4m3 forward operands and e5m2 gradient operands,
fp32 accumulation, under current or delayed scaling.

Counterpart of ``accelerate_tpu/ops/fp8.py`` (the reference's
TransformerEngine / MS-AMP recipe). The models call
:func:`module_fp8_dot` (and :func:`fp8_attn_proj` / :func:`fp8_attn_out`
for the attention projections) where their config sets ``use_fp8``:

- current scaling (``fp8_recipe="current"``): each operand's scale is its
  own amax over the dtype's max, every call;
- delayed scaling (``"delayed"``, TransformerEngine's ``DelayedScaling``):
  the forward operands' scales come from an amax history of earlier
  steps, ``[2, H]`` fp32 per projection (row 0 the activation's, row 1
  the weight's; slot 0 the step in progress), and each training forward
  max-accumulates its amaxes into slot 0. :func:`roll_amax_histories`
  advances the slots once per optimizer step. Gradients keep current
  e5m2 scaling.

Scales are computed as the reference's XLA computes them: a product with
the float32 reciprocal of the dtype's max, ``amax * fl(1/fmax)`` (XLA
turns the division by a constant into it), 1.0 where the amax is 0; a
quotient would move about half the scales by an ulp. Given the scale,
``clamp(x / scale)`` rounds to fp8 as the reference does, so amax, scale
and quantized bytes agree bit for bit.

The product has two routes, as every op of the port: a CPU tensor takes
the plain version, ``(qa.float() @ qb.float()) * (sa * sb)`` cast to the
output dtype (the reference's ``dot_general`` with fp32 accumulation); a
CUDA tensor takes ``torch._scaled_mm`` on the H100's fp8 tensor cores or
raises, never a bf16 matmul. The reference's product is XLA's
``dot_general`` and no Pallas kernel, so the card's product is the
library's: this module adds no kernel. ``_scaled_mm`` takes a row-major
mat1 whose inner dim is a multiple of 16 and a column-major mat2 whose
both dims are; the contraction axis is padded with zeros to the multiple
(exact: zeros move neither an amax nor a sum), which only the weight
gradient's contraction over the token count can need, and an output
width that is not a multiple of 16 raises with the shape. e5m2 x e5m2
is never asked for: the gradient meets an e4m3 operand in both
backward products.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
# _scaled_mm's alignment: mat1's inner dim and both of mat2's dims
MM_MULTIPLE = 16

# torch._scaled_mm calls since the last reset_product_count(): the fp8
# products that ran on the card (the plain version counts nowhere)
product_count = 0


def reset_product_count():
    global product_count
    product_count = 0


def _reciprocal(fmax: float) -> float:
    """fl(1 / fmax) in float32, exactly representable as a Python float."""
    return float(np.float32(1.0) / np.float32(fmax))


def amax_of(x: torch.Tensor) -> torch.Tensor:
    """max |x| as a float32 scalar tensor (exact in any float dtype; one
    pass, no |x| copy)."""
    lo, hi = torch.aminmax(x.detach())
    return torch.maximum(-lo, hi).float()


def _scale_of(amax: torch.Tensor, fmax: float) -> torch.Tensor:
    return torch.where(amax > 0, amax * _reciprocal(fmax), torch.ones_like(amax))


def _amax_scale(x: torch.Tensor, fmax: float) -> torch.Tensor:
    """fp32 scale mapping x's current amax to the fp8 dtype's max."""
    return _scale_of(amax_of(x), fmax)


def _quantize_with(x: torch.Tensor, scale: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    # in fp32: x / scale rounded once, to fp8 (a bf16 quotient would round twice)
    return x.detach().to(torch.float32, copy=True).div_(scale).clamp_(-fmax, fmax).to(dtype)


def quantize_fp8(x: torch.Tensor, dtype=E4M3, fmax: float = E4M3_MAX):
    """(q, scale): q = clip(x / scale) in fp8, x ~= q * scale."""
    scale = _amax_scale(x, fmax)
    return _quantize_with(x, scale, dtype, fmax), scale


def _scaled_product(qx: torch.Tensor, qy: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """``(qx @ qy) * (sx * sy)`` in ``out_dtype``: qx [M, K], qy [K, N]
    fp8 of any layout, fp32 accumulation. The plain version on the CPU,
    ``torch._scaled_mm`` on the card."""
    if qx.device.type == "cpu":
        return scaled_product_reference(qx, qy, sx, sy, out_dtype)
    if qx.device.type != "cuda":
        raise RuntimeError(f"fp8 product on {qx.device}: neither CPU nor CUDA")
    return scaled_mm(qx, qy, sx, sy, out_dtype)


def scaled_product_reference(qx, qy, sx, sy, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the fp8 operands in fp32, one fp32 product (exact
    products of fp8 values, summed in fp32), scaled, rounded once."""
    return ((qx.float() @ qy.float()) * (sx * sy)).to(out_dtype)


def scaled_mm(qx, qy, sx, sy, out_dtype: torch.dtype) -> torch.Tensor:
    """The card's product: ``torch._scaled_mm`` over a row-major mat1 and a
    column-major mat2, the contraction axis padded with zeros to a
    multiple of 16; counted in :data:`product_count`."""
    k, n = qy.shape
    if n % MM_MULTIPLE:
        raise ValueError(f"fp8 product of [{qx.shape[0]}, {k}] @ [{k}, {n}]: the output "
                         f"width {n} is not a multiple of {MM_MULTIPLE} (torch._scaled_mm)")
    pad = -k % MM_MULTIPLE
    mat1 = qx.contiguous()
    mat2 = qy.t().contiguous()  # [N, K] row-major: column-major [K, N] once transposed
    if pad:
        mat1 = _pad_last(mat1, pad)
        mat2 = _pad_last(mat2, pad)
    out = torch._scaled_mm(mat1, mat2.t(), scale_a=sx.reshape(()), scale_b=sy.reshape(()),
                           out_dtype=out_dtype)
    global product_count
    product_count += 1
    return out[0] if isinstance(out, tuple) else out  # torch < 2.4 also returns the amax


def _pad_last(q: torch.Tensor, pad: int) -> torch.Tensor:
    out = q.new_zeros(q.shape[0], q.shape[1] + pad)
    out[:, :q.shape[1]].copy_(q)
    return out


def _forward(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor):
    """e4m3 x e4m3 at the given scales: a [..., K] @ b [K, N] in a's dtype."""
    qa = _quantize_with(a.reshape(-1, a.shape[-1]), sa, E4M3, E4M3_MAX)
    qb = _quantize_with(b, sb, E4M3, E4M3_MAX)
    out = _scaled_product(qa, qb, sa, sb, a.dtype)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _Fp8Dot(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward at the given scales
    (None: current scaling), the backward requantizing the saved
    unquantized operands (its residuals) under current scaling: ``da = g
    (e5m2) @ b^T (e4m3)``, ``db = a^T (e4m3) @ g (e5m2)`` over every token."""

    @staticmethod
    def forward(ctx, a, b, sa, sb):
        ctx.save_for_backward(a, b)
        if sa is None:
            sa = _amax_scale(a, E4M3_MAX)
            sb = _amax_scale(b, E4M3_MAX)
        return _forward(a, b, sa, sb)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qg, sg = quantize_fp8(g.reshape(-1, g.shape[-1]), E5M2, E5M2_MAX)
        da = db = None
        if ctx.needs_input_grad[0]:
            qb, sb = quantize_fp8(b)
            da = _scaled_product(qg, qb.t(), sg, sb, a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            qa, sa = quantize_fp8(a.reshape(-1, a.shape[-1]))
            db = _scaled_product(qa.t(), qg, sa, sg, b.dtype)
        return da, db, None, None


def fp8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ b [K, N] with e4m3 forward operands, fp32 accumulation,
    e5m2 gradient operands. Output dtype follows ``a``."""
    return _Fp8Dot.apply(a, b, None, None)


def maybe_fp8_dot(a: torch.Tensor, b: torch.Tensor, use_fp8: bool) -> torch.Tensor:
    """The fp8 recipe when enabled, the plain product otherwise."""
    return fp8_dot(a, b) if use_fp8 else a @ b


# -- delayed scaling (TransformerEngine DelayedScaling) ----------------------


def init_amax_history(length: int = 16, device=None) -> torch.Tensor:
    """[2, H] fp32 amax history for one contraction's (a, b) operands."""
    return torch.zeros((2, length), dtype=torch.float32, device=device)


def _delayed_scale(hist_row: torch.Tensor, fmax: float, margin: float = 1.0) -> torch.Tensor:
    """TE's recipe: the scale from the history's max (``amax_compute_algo=
    "max"``) times a safety margin, 1.0 before any history exists."""
    return _scale_of(hist_row.amax() * margin, fmax)


def _roll_in(hist_row: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """``amax`` pushed in as the newest slot, the oldest dropped."""
    return torch.cat([amax.reshape(1).to(hist_row.dtype), hist_row[:-1]])


def _record_amax(hist_row: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """This call's amax max-accumulated into the current slot (slot 0): a
    new row. The slot advances once per optimizer step
    (:func:`roll_amax_histories`), so accumulation micro-steps share it."""
    return torch.cat([torch.maximum(hist_row[:1], amax.reshape(1)), hist_row[1:]])


def roll_amax_histories(stats):
    """Advance every amax history one step: shift the slots, zero the new
    current slot. ``stats`` is a [..., 2, H] tensor or a dict / list /
    tuple of them (a model's ``fp8_histories()``, the reference's
    ``fp8_stats`` tree); returns new tensors in the same structure. A port
    model (``fp8_histories()``) is rolled in place and returned: what a
    custom loop that bypasses the Accelerator's updates calls once per
    optimizer step."""
    if hasattr(stats, "fp8_histories"):
        with torch.no_grad():
            for h in stats.fp8_histories().values():
                h.copy_(roll_amax_histories(h))
        return stats
    if isinstance(stats, dict):
        return type(stats)((k, roll_amax_histories(v)) for k, v in stats.items())
    if isinstance(stats, (list, tuple)):
        return type(stats)(roll_amax_histories(v) for v in stats)
    return torch.cat([torch.zeros_like(stats[..., :1]), stats[..., :-1]], dim=-1)


def fp8_dot_delayed(a: torch.Tensor, b: torch.Tensor, hist: torch.Tensor,
                    margin: float = 1.0):
    """``a [..., K] @ b [K, N]`` under delayed scaling: forward scales from
    ``hist`` [2, H] (earlier steps' amaxes), this call's amaxes recorded
    into slot 0 of a new history. Returns ``(out, new_hist)``; ``hist`` is
    not changed."""
    sa = _delayed_scale(hist[0], E4M3_MAX, margin)
    sb = _delayed_scale(hist[1], E4M3_MAX, margin)
    return fp8_dot_with_scales(a, b, sa, sb), _recorded(hist, a, b)


def _recorded(hist: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``hist`` [2, H] with this call's amaxes of ``a`` and ``b`` recorded."""
    return torch.stack([_record_amax(hist[0], amax_of(a)), _record_amax(hist[1], amax_of(b))])


def fp8_dot_with_scales(a, b, sa, sb) -> torch.Tensor:
    """The forward at given e4m3 scales; the backward under current
    scaling, as :func:`fp8_dot`'s."""
    return _Fp8Dot.apply(a, b, sa, sb)


class Fp8Forward:
    """One forward's view of a model's amax histories (the reference's
    ``fp8_stats`` collection in one ``apply``): ``record`` says whether
    the forward writes its amaxes (a training forward, the collection
    mutable) or only reads the histories (an evaluation forward, or a user
    ``loss_fn``'s, whose writes the reference discards). ``scales`` keeps
    each projection's scales from its first call, so the recompute of a
    checkpointed block reads the same scales and records nothing twice."""

    def __init__(self, record: bool):
        self.record = record
        self.scales: dict = {}


def _delayed_scales(module, name: str, hist: torch.Tensor, fwd: Fp8Forward, a, b):
    key = (id(module), name)
    if key not in fwd.scales:
        sa = _delayed_scale(hist[0], E4M3_MAX)
        sb = _delayed_scale(hist[1], E4M3_MAX)
        if fwd.record:
            with torch.no_grad():
                hist.copy_(_recorded(hist, a, b))
        fwd.scales[key] = (sa, sb)
    return fwd.scales[key]


_delayed_fallback_warned = False


def _warn_delayed_fallback_once():
    """The delayed recipe was asked for but this forward runs current
    scaling: the model holds no histories (built without the recipe, and
    ``Accelerator(mixed_precision="fp8")`` turned fp8 on later), or this
    forward has none (generation and serving run a model as the
    reference applies ``{"params": ...}`` alone). One notice."""
    global _delayed_fallback_warned
    if _delayed_fallback_warned:
        return
    _delayed_fallback_warned = True
    warnings.warn(
        "fp8_recipe='delayed' is configured but this forward has no amax "
        "histories, so CURRENT scaling is used for it. If this is "
        "inference/generation (a cached forward), that is expected: the "
        "amax history is a training-time state. If this is training, build "
        "the model with use_fp8=True and fp8_recipe='delayed' so the "
        "history buffers exist.",
        stacklevel=3,
    )


def module_fp8_dot(module, name: str, a: torch.Tensor, b: torch.Tensor, cfg) -> torch.Tensor:
    """The contraction of a model module whose config carries ``use_fp8``
    / ``fp8_recipe``: the plain product when off, current-scaling fp8 by
    default, or delayed scaling over the module's history buffer ``name``
    ([2, H] fp32) within the forward its model opened
    (``module.fp8_forward``, an :class:`Fp8Forward`; None in a cached
    forward)."""
    if not getattr(cfg, "use_fp8", False):
        return a @ b
    if getattr(cfg, "fp8_recipe", "current") != "delayed":
        return fp8_dot(a, b)
    hist: Optional[torch.Tensor] = getattr(module, name, None)
    fwd: Optional[Fp8Forward] = getattr(module, "fp8_forward", None)
    if hist is None or fwd is None:
        _warn_delayed_fallback_once()
        return fp8_dot(a, b)
    sa, sb = _delayed_scales(module, name, hist, fwd, a, b)
    return fp8_dot_with_scales(a, b, sa, sb)


def fp8_attn_proj(module, name: str, x, w, num_heads: int, head_dim: int, cfg):
    """Attention input projection under the fp8 recipe: ``x [b, s, e] @
    w [e, nh, d]`` as one 2D contraction, returned as [b, nh, s, d]."""
    e = w.shape[0]
    b, s = x.shape[0], x.shape[1]
    out = module_fp8_dot(module, name, x, w.reshape(e, num_heads * head_dim), cfg)
    return out.reshape(b, s, num_heads, head_dim).transpose(1, 2)


def fp8_attn_out(module, name: str, attn, w, cfg):
    """Attention output projection under fp8: ``attn [b, h, s, d] @
    w [h, d, e]`` -> [b, s, e]."""
    b, h, s, d = attn.shape
    a2 = attn.transpose(1, 2).reshape(b, s, h * d)
    return module_fp8_dot(module, name, a2, w.reshape(h * d, w.shape[-1]), cfg)


# the history buffers' names, as the reference's fp8_stats collection
# names them: an attention's four projections and a gated MLP's three
ATTENTION_HISTORIES = ("wq_fp8", "wk_fp8", "wv_fp8", "wo_fp8")
MLP_HISTORIES = ("gate", "up", "down")
# BERT's MLP (models/encoder.py)
ENCODER_MLP_HISTORIES = ("mlp_in", "mlp_out")
HISTORY_NAMES = ATTENTION_HISTORIES + MLP_HISTORIES + ENCODER_MLP_HISTORIES


def delayed(config) -> bool:
    """True when a model built from ``config`` holds amax histories."""
    return bool(getattr(config, "use_fp8", False)) and \
        getattr(config, "fp8_recipe", "current") == "delayed"


def register_histories(module, names, config, device):
    """Zero [2, fp8_amax_history_len] fp32 history buffers ``names`` on
    ``module`` when ``config`` asks for delayed scaling."""
    if delayed(config):
        for name in names:
            module.register_buffer(name, init_amax_history(config.fp8_amax_history_len, device))
