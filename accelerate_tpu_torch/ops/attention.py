"""Attention: plain PyTorch versions and the dispatch to the hand-written
Hopper kernels.

Counterpart of ``accelerate_tpu/ops/attention.py``. Layouts match the
reference's public functions: q [B, H, S, D], k/v [B, KVH, S, D], paged
K/V leaves [num_pages, KVH, page_size, D], page tables [B, P] int32.
Query head ``h`` reads kv head ``h // group``, so K/V are never expanded.

Each kernel sits beside its plain version:

- :func:`paged_decode_attention` -> ``ops/kernels.paged_decode`` /
  ``paged_decode_quant`` (csrc/paged_decode.cu, paged_decode_quant.cu
  over csrc/decode_common.cuh); plain version
  :func:`paged_decode_reference`. The kernels split each slot's kv walk
  and merge the splits' partials in a second pass, whose plain version is
  :func:`merge_decode_partials` (with :func:`decode_partial_reference`,
  the plain partial of one kv range).
- :func:`decode_attention` -> ``ops/kernels.dense_decode`` /
  ``dense_decode_quant`` (csrc/dense_decode.cu, dense_decode_quant.cu
  over the same csrc/decode_common.cuh, with a dense row addressing) at
  decode widths (Sq <= 16); plain version
  :func:`decode_attention_reference`, which is also the read of wider
  query blocks, as in the reference.
- :func:`ragged_prefill_attention` -> ``ops/kernels.ragged_prefill`` /
  ``ragged_prefill_quant`` (csrc/ragged_prefill.cu,
  ragged_prefill_quant.cu); plain version :func:`ragged_prefill_reference`
  (quantize-on-write: :func:`_quantize_block`).
- :func:`flash_attention` (one differentiable operator,
  :func:`flash_fwd_op`), :func:`flash_attention_with_lse` and
  :func:`flash_attention_bwd` -> ``ops/kernels.flash_fwd`` /
  ``flash_bwd_dq`` / ``flash_bwd_dkv`` and their fp16 entries
  (csrc/flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu, bf16 and fp16);
  plain versions :func:`flash_fwd_reference`, :func:`flash_bwd_dq_reference`
  and :func:`flash_bwd_dkv_reference`, which compute in fp32 and round
  where the kernels round, to the inputs' dtype (bf16 or fp16).
- :func:`dot_product_attention` dispatches between the flash kernels and
  :func:`mha_reference`, as the reference's dispatcher does.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. Nothing falls back from the device to the plain version.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() semantics with no NaN risk

# default packed-prefill token block: each admission tail pads to this
PREFILL_TOKEN_BLOCK = 8
# widest multi-query decode the kernel takes (decode 1, speculative verify K+1)
DECODE_KERNEL_MAX_SQ = 16
# what the paged decode kernels take: head dims (the reference's compiled
# gate, a 64-multiple) and query rows per kv head, R = group * Sq (four
# 16-row tiles of their mma.sync products)
DECODE_KERNEL_HEAD_DIMS = (64, 128)
DECODE_KERNEL_MAX_ROWS = 64
# what the flash kernels take: head dims, and the tile every sequence
# length must fill (the public functions ask for the reference's
# 128-multiples, see _pick_block)
FLASH_KERNEL_HEAD_DIMS = (64, 128)
FLASH_KERNEL_SEQ_MULTIPLE = 64
# head dims the ragged prefill kernels take (one or two 64-column boxes)
PREFILL_KERNEL_HEAD_DIMS = (64, 128)
# the ragged prefill kernels' kv tile: a packed row walks its slot's arena
# prefix in 64-position tiles from position 0, then the slot's fresh rows
# in 64-row tiles of the pack, with an online softmax over the tiles
PREFILL_KV_TILE = 64


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention. q: [B, H, Sq, D]; k/v: [B, KVH, Skv, D]. ``bias``
    is additive, broadcastable to [B, H, Sq, Skv]. Scores and softmax run
    in fp32; probabilities are cast to v's dtype before the PV product."""
    orig_dtype = q.dtype
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, kvh, group, sq, d)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg.float(), k.float()) * sm_scale
    if bias is not None:
        bias32 = torch.broadcast_to(bias.float(), (b, h, sq, skv))
        s = s + bias32.reshape(b, kvh, group, sq, skv)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril(skv - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p.to(v.dtype), v)
    return out.reshape(b, h, sq, d).to(orig_dtype)


def decode_attention_dense(q, k, v, *, q_positions, sm_scale=None):
    """The masked-dense decode read: query row t attends cache slot c iff
    ``c <= q_positions[..., t]``. q [B, H, Sq, D]; k/v [B, KVH, L, D];
    ``q_positions`` [Sq] (shared) or [B, Sq]."""
    kv_pos = torch.arange(k.shape[2], device=q.device)
    if q_positions.dim() == 1:
        ok = kv_pos[None, :] <= q_positions[:, None]
        bias = torch.where(ok, 0.0, NEG_INF)[None, None]  # [1, 1, Sq, L]
    else:
        ok = kv_pos[None, None, :] <= q_positions[:, :, None]
        bias = torch.where(ok, 0.0, NEG_INF)[:, None]  # [B, 1, Sq, L]
    return mha_reference(q, k, v, causal=False, sm_scale=sm_scale, bias=bias)


def gather_kv_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-slot dense K (or V) from a paged arena: ``pages`` [NP, KVH, ps, D],
    ``page_table`` [B, P] (position-ordered) -> [B, KVH, P*ps, D]. Duplicate
    table entries (the parking page padding unallocated tail entries) are
    fine: their rows sit past the slot's frontier and the mask zeroes them."""
    g = pages[page_table.long()]                  # [B, P, KVH, ps, D]
    g = g.transpose(1, 2)                         # [B, KVH, P, ps, D]
    b, kvh, p, ps, d = g.shape
    return g.reshape(b, kvh, p * ps, d)


def paged_decode_reference(q, k_pages, v_pages, page_table, q_positions, sm_scale, *,
                           k_scale=None, v_scale=None, kv_quant_bits: int = 0):
    """Plain paged decode: gather each slot's pages into position order
    (a quantized arena's scale pages too), then the masked-dense read of
    :func:`decode_attention_reference`, which dequantizes first, as the
    reference's gather path does."""
    k_full = gather_kv_pages(k_pages, page_table)
    v_full = gather_kv_pages(v_pages, page_table)
    if kv_quant_bits:
        return decode_attention_reference(
            q, k_full, v_full, q_positions, sm_scale,
            k_scale=gather_kv_pages(k_scale, page_table),
            v_scale=gather_kv_pages(v_scale, page_table), kv_quant_bits=kv_quant_bits,
        )
    return decode_attention_dense(
        q, k_full, v_full, q_positions=q_positions, sm_scale=sm_scale
    )


def decode_partial_reference(q, k, v, q_positions, lo: int, hi: int, sm_scale):
    """The plain partial of one split of the decode kernels' kv walk: the
    masked-dense read of :func:`decode_attention_dense` restricted to kv
    positions ``lo <= c < hi``. q [B, H, Sq, D], k/v [B, KVH, L, D],
    ``q_positions`` [B, Sq] -> ``(m, l, acc)``: per query row the max
    score m [B, H, Sq] (-inf where the row attends nothing in the range),
    l = sum exp(s - m) and acc = sum p v [B, H, Sq, D] with p cast to v's
    dtype before the product, all zero where m is -inf. The kernels keep m
    in log2 units (m log2 e); this is the same state in natural units."""
    b, h, sq, d = q.shape
    kvh, length = k.shape[1], k.shape[2]
    group = h // kvh
    qg = q.reshape(b, kvh, group, sq, d).float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * sm_scale
    c = torch.arange(length, device=q.device)
    ok = (c >= lo) & (c < hi) & (c[None, None, :] <= q_positions[:, :, None].long())
    s = torch.where(ok[:, None, None], s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
    acc = torch.einsum("bkgqc,bkcd->bkgqd", p.to(v.dtype), v).float()
    return (m.reshape(b, h, sq), p.sum(dim=-1).reshape(b, h, sq),
            acc.reshape(b, h, sq, d))


def merge_decode_partials(m, l, acc):
    """The plain version of the decode kernels' merge pass: partials of S
    splits, m / l [S, ...] and acc [S, ..., D] (natural units, as
    :func:`decode_partial_reference` gives them) -> ``sum_i acc_i
    exp(m_i - M) / sum_i l_i exp(m_i - M)``, M = max_i m_i, in fp32. A
    partial with m_i = -inf weighs exactly 0, and a row with no weight at
    all gives 0 (the reference's ``safe_l``)."""
    big = m.amax(dim=0)
    finite = ~torch.isinf(big)
    w = torch.where(torch.isinf(m), torch.zeros_like(m),
                    torch.exp(m - torch.where(finite, big, torch.zeros_like(big))))
    num = (acc.float() * w[..., None]).sum(dim=0)
    den = (l.float() * w).sum(dim=0)
    return num / torch.where(den == 0, torch.ones_like(den), den)[..., None]


def _positions_2d(q_positions: torch.Tensor, b: int) -> torch.Tensor:
    pos = q_positions.to(torch.int32)
    if pos.dim() == 1:  # [Sq] shared across the batch
        pos = pos[None, :].expand(b, pos.shape[0])
    return pos.contiguous()


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    *,
    page_table: torch.Tensor,
    q_positions: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    kv_quant_bits: int = 0,
) -> torch.Tensor:
    """Decode attention reading K/V through a per-slot page table.

    q [B, H, Sq, D]; k_pages/v_pages [NP, KVH, ps, D]; ``page_table``
    [B, P] int32; ``q_positions`` [B, Sq] (or [Sq]) global positions.
    ``kv_quant_bits`` (8 or 4, with ``k_scale`` / ``v_scale``
    [NP, KVH, ps, 1] fp32, the scale pages beside the payload pages): the
    pages hold int8 payloads [NP, KVH, ps, D] (int4: D / 2, two values a
    byte). On a CUDA tensor the paged decode kernel (or its quantized
    entry, dequantizing on chip) walks each slot's live pages straight
    from the arena, split across blocks, and merges the splits; on a CPU
    tensor the plain gather + masked dense read runs."""
    from . import kernels

    if kv_quant_bits and (k_scale is None or v_scale is None):
        raise ValueError("kv_quant_bits needs k_scale and v_scale")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    pos = _positions_2d(q_positions, q.shape[0])
    if kv_quant_bits:
        return kernels.paged_decode_quant(q, k_pages, v_pages, k_scale, v_scale,
                                          page_table, pos, scale, kv_quant_bits)
    return kernels.paged_decode(q, k_pages, v_pages, page_table, pos, scale)


def decode_attention_reference(q, k, v, q_positions, sm_scale=None, *, k_scale=None,
                               v_scale=None, kv_quant_bits: int = 0):
    """Plain dense-cache decode: a quantized cache (``kv_quant_bits`` 8 or
    4) is dequantized first with ``dequantize_kv``, then the masked-dense
    read :func:`decode_attention_dense` runs."""
    if kv_quant_bits:
        from ..utils.quantization import dequantize_kv

        k = dequantize_kv(k, k_scale, kv_quant_bits, q.dtype)
        v = dequantize_kv(v, v_scale, kv_quant_bits, q.dtype)
    return decode_attention_dense(q, k, v, q_positions=q_positions, sm_scale=sm_scale)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    kv_quant_bits: int = 0,
) -> torch.Tensor:
    """Decode attention over a dense cache with per-row validity.

    q [B, H, Sq, D]; k/v [B, KVH, L, D], the whole cache, already holding
    the query rows' own K/V. ``q_positions`` [Sq] (shared by the batch:
    single-stream decode) or [B, Sq] (per-slot: the flat serving arena) is
    each query row's global position; it attends cache position c iff
    ``c <= its position``. ``kv_quant_bits`` (8 or 4, with ``k_scale`` /
    ``v_scale`` [B, KVH, L, 1] fp32): k/v are int8 payloads (int4 packed
    two a byte along D).

    At decode widths (Sq <= 16) the dense decode kernel reads only each
    row's live positions, split across blocks, and merges the splits (its
    plain version on a CPU tensor). A wider Sq
    takes the masked-dense read, as the reference's dispatch does by
    design (``_DECODE_KERNEL_MAX_SQ``): such a block is prefill-shaped."""
    from . import kernels

    if kv_quant_bits and (k_scale is None or v_scale is None):
        raise ValueError("kv_quant_bits needs k_scale and v_scale")
    sq, d = q.shape[2], q.shape[3]
    if sq > DECODE_KERNEL_MAX_SQ:
        return decode_attention_reference(q, k, v, q_positions, sm_scale, k_scale=k_scale,
                                          v_scale=v_scale, kv_quant_bits=kv_quant_bits)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    pos = _positions_2d(q_positions, q.shape[0])
    if kv_quant_bits:
        return kernels.dense_decode_quant(q, k, v, k_scale, v_scale, pos, scale,
                                          kv_quant_bits)
    return kernels.dense_decode(q, k, v, pos, scale)


def _quantize_block(x: torch.Tensor, bits: int):
    """The ragged prefill kernel's quantize-on-write, copied from the
    reference's ``_quantize_block`` (accelerate_tpu/ops/attention.py:1315):
    per row over D, ``scale = amax / qmax`` (1.0 where amax is 0) and
    ``qf = clamp(round(x32 / scale), -qmax, qmax)``. It DIVIDES by the
    scale, where ``utils.quantization.quantize_kv`` (the decode-time
    writes) multiplies by its reciprocal; the two can give payloads one
    step apart where ``x / scale`` lies within an ulp of a .5 tie. Returns
    ``(payload int8 [..., D or D / 2], scale fp32 [..., 1], qf * scale
    fp32 [..., D])``; int4 packs pairs, the even index in the low nibble."""
    qmax = float((1 << (bits - 1)) - 1)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch turns a division by a Python scalar on
    # CUDA into a product with its reciprocal, which is not amax / qmax
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
    qf = torch.clamp(torch.round(x32 / scale), -qmax, qmax)
    payload = qf.to(torch.int8)
    if bits == 4:
        payload = (payload[..., 0::2] & 0x0F) | ((payload[..., 1::2] & 0x0F) << 4)
    return payload, scale, qf * scale


def ragged_prefill_reference(q, k_new, v_new, k_pages, v_pages, page_table,
                             row_slot, row_pos, slot_hist, scale, *, k_scale=None,
                             v_scale=None, kv_quant_bits: int = 0):
    """Plain packed ragged prefill: per-row gathered arena context plus the
    packed fresh K/V, masked exactly as the kernel masks, fp32 softmax.
    Pad rows (slot or position -1) output exactly 0. Returns
    ``(out [1, H, CAP, D], k_payload, k_scale, v_payload, v_scale)`` with
    the payloads token-major [CAP, KVH, pd] for the caller's arena scatter
    (unquantized: k_new / v_new themselves and no scales).

    Quantized (``kv_quant_bits`` 8 or 4, scale pages ``k_scale`` /
    ``v_scale``): the arena context is dequantized with ``dequantize_kv``;
    every packed row, pads included, is quantized with
    :func:`_quantize_block`, and the fresh tail is attended over
    ``qf * scale`` rounded once to q's dtype, the values the cache serves
    later. This is the plain version of the KERNEL, so it divides by the
    scale as the kernel does and the CUDA kernel's payloads can be held
    bit for bit against it; the reference's own plain
    ``_ragged_prefill_reference`` quantizes with ``quantize_kv`` instead."""
    _, h, cap, d = q.shape
    kvh = k_pages.shape[1]
    group = h // kvh
    row_slot = row_slot.long()
    row_pos = row_pos.long()
    slot_hist = slot_hist.long()
    kn_t = k_new[0].transpose(0, 1)  # [CAP, KVH, D]
    vn_t = v_new[0].transpose(0, 1)
    k_ctx = gather_kv_pages(k_pages, page_table)  # [S, KVH, L, pd]
    v_ctx = gather_kv_pages(v_pages, page_table)
    k_scl = v_scl = None
    kf, vf = k_new[0], v_new[0]  # [KVH, CAP, D]: what the fresh tail attends
    if kv_quant_bits:
        from ..utils.quantization import dequantize_kv

        k_ctx = dequantize_kv(k_ctx, gather_kv_pages(k_scale, page_table), kv_quant_bits,
                              q.dtype)
        v_ctx = dequantize_kv(v_ctx, gather_kv_pages(v_scale, page_table), kv_quant_bits,
                              q.dtype)
        kn_t, k_scl, k_deq = _quantize_block(kn_t, kv_quant_bits)
        vn_t, v_scl, v_deq = _quantize_block(vn_t, kv_quant_bits)
        kf = k_deq.to(q.dtype).transpose(0, 1)
        vf = v_deq.to(q.dtype).transpose(0, 1)
    sl = row_slot.clamp(min=0)
    k_row = k_ctx[sl]  # [CAP, KVH, L, D]: per-row slot context
    v_row = v_ctx[sl]
    qg = q[0].reshape(kvh, group, cap, d)
    s_ctx = torch.einsum("kgrd,rkld->kgrl", qg.float(), k_row.float()) * scale
    length = k_row.shape[2]
    lpos = torch.arange(length, device=q.device)
    hist_r = torch.where(row_slot >= 0, slot_hist[sl], torch.zeros_like(sl))
    valid_ctx = (lpos[None, :] < hist_r[:, None]) & (lpos[None, :] <= row_pos[:, None])
    s_ctx = torch.where(valid_ctx[None, None], s_ctx, torch.full_like(s_ctx, NEG_INF))
    s_new =torch.einsum("kgrd,kcd->kgrc", qg.float(), kf.float()) * scale
    valid_new = ((row_slot[None, :] == row_slot[:, None])
                 & (row_slot[:, None] >= 0)
                 & (row_pos[None, :] <= row_pos[:, None])
                 & (row_pos[None, :] >= 0))
    s_new = torch.where(valid_new[None, None], s_new, torch.full_like(s_new, NEG_INF))
    p = torch.softmax(torch.cat([s_ctx, s_new], dim=-1), dim=-1)
    out = (torch.einsum("kgrl,rkld->kgrd", p[..., :length].to(v_row.dtype), v_row)
           + torch.einsum("kgrc,kcd->kgrd", p[..., length:].to(vf.dtype), vf))
    # pad rows are fully masked (softmax degenerates to uniform): force
    # the kernel's exact 0 output instead
    row_ok = (row_slot >= 0) & (row_pos >= 0)
    out = torch.where(row_ok[None, None, :, None], out, torch.zeros_like(out))
    out = out.reshape(h, cap, d)[None].to(q.dtype)
    return out, kn_t, k_scl, vn_t, v_scl


def ragged_prefill_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    *,
    page_table: torch.Tensor,
    row_slot: torch.Tensor,
    row_pos: torch.Tensor,
    slot_hist: torch.Tensor,
    sm_scale: Optional[float] = None,
    token_block: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    kv_quant_bits: int = 0,
):
    """Packed ragged prefill attention over the paged KV arena, with
    quantize-on-write fused for a quantized arena.

    q/k_new/v_new [1, H|KVH, CAP, D]: the packed fresh tails of every
    admission in this dispatch (post-RoPE). ``row_slot``/``row_pos`` [CAP]
    int32 map each packed row to its (slot, absolute position); -1 marks
    padding. Rows of one slot are contiguous, position-ordered and
    token-block aligned (the packer's contract). ``slot_hist`` [S] int32
    is each slot's live prefix already in the arena. Each row attends its
    slot's arena prefix ``[0, hist)`` plus the packed fresh rows of the
    same slot at or below its own position. ``kv_quant_bits`` (8 or 4,
    with ``k_scale`` / ``v_scale`` [NP, KVH, ps, 1] fp32): the pages are
    int8 payloads, read dequantized; the fresh rows are quantized and
    attended dequantized.

    Returns ``(out [1, H, CAP, D], k_payload, k_scale, v_payload,
    v_scale)``, payloads token-major [CAP, KVH, pd] and scales [CAP, KVH,
    1] for the caller's arena scatter (unquantized: k_new / v_new
    themselves and None). A CUDA tensor launches the ragged prefill kernel
    (or its quantized entry); a CPU tensor runs
    :func:`ragged_prefill_reference`."""
    from . import kernels

    b, h, cap, d = q.shape
    if b != 1:
        raise ValueError(f"packed ragged prefill takes batch 1, got {b}")
    bt = int(token_block or PREFILL_TOKEN_BLOCK)
    if cap % bt:
        raise ValueError(
            f"packed capacity {cap} must be a multiple of the token block {bt}"
        )
    if kv_quant_bits and (k_scale is None or v_scale is None):
        raise ValueError("kv_quant_bits needs k_scale and v_scale")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    rows = (row_slot.to(torch.int32), row_pos.to(torch.int32), slot_hist.to(torch.int32))
    if kv_quant_bits:
        return kernels.ragged_prefill_quant(
            q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, page_table, *rows,
            scale, bt, kv_quant_bits,
        )
    return kernels.ragged_prefill(q, k_new, v_new, k_pages, v_pages, page_table, *rows,
                                  scale, bt)


# ---------------------------------------------------------------------------
# flash attention (the training path): plain versions of the three kernels,
# the autograd Function, the public functions and the dispatcher.
#
# Semantics of the reference's Pallas kernels (accelerate_tpu/ops/
# attention.py _mask_block / _fwd_kernel / _dq_kernel / _dkv_kernel):
# causal is ``col <= row`` on global indices (top-left aligned, unlike
# mha_reference's bottom-right ``tril(k = skv - sq)``; the two agree when
# Sq == Skv); ``kv_mask`` [B, Skv] nonzero may be attended; segment ids
# [B, S] attend iff equal; masked scores are NEG_INF and masked p is
# exactly 0. A row with no attended key gives out = 0 and lse = NEG_INF
# (the reference's forward gives the mean of the V rows it visited there;
# its backward treats the row as empty, as both versions here do).
# ``masks`` is the tuple ``(kv_mask, q_seg, kv_seg)``, entries int32 or None.
# ---------------------------------------------------------------------------


def _pick_block(s: int) -> int:
    """The reference's block choice (ops/attention.py _pick_block): the
    public flash functions take what it takes, sequence lengths that are
    multiples of 128. The kernels' own tiles are smaller (64)."""
    for cand in (1024, 512, 256, 128):
        if cand <= s and s % cand == 0:
            return cand
    return 0


def _flash_valid(q, k, masks, causal: bool):
    """Validity of every (row, col) as a bool tensor broadcastable to
    [B, KVH, G, Sq, Skv], or None when nothing is masked."""
    kv_mask, q_seg, kv_seg = masks
    sq, skv = q.shape[2], k.shape[2]
    valid = None

    def both(a, m):
        return m if a is None else a & m

    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        valid = (cols <= rows)[None, None, None]
    if kv_mask is not None:
        valid = both(valid, (kv_mask != 0)[:, None, None, None, :])
    if q_seg is not None:
        valid = both(valid, (q_seg[:, :, None] == kv_seg[:, None, :])[:, None, None])
    return valid


def _grouped(x, kvh):
    b, h, s, d = x.shape
    return x.reshape(b, kvh, h // kvh, s, d)


def _flash_scores(q, k, masks, causal, sm_scale):
    """fp32 scores [B, KVH, G, Sq, Skv], masked entries NEG_INF, and the
    validity (None when unmasked)."""
    qg = _grouped(q, k.shape[1])
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg.float(), k.float()) * sm_scale
    valid = _flash_valid(q, k, masks, causal)
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return s, valid


def flash_fwd_reference(q, k, v, masks, causal: bool, sm_scale: float):
    """Plain version of the flash forward kernel -> ``(out, lse [B, H, Sq]
    fp32)``: one softmax over the whole row instead of the kernel's online
    one, p rounded to v's dtype before the PV product, out = acc / l."""
    b, h, sq, d = q.shape
    s, valid = _flash_scores(q, k, masks, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.einsum("bkgqc,bkcd->bkgqd", p.to(v.dtype).float(), v.float())
    out = (acc / safe_l).reshape(b, h, sq, d).to(q.dtype)
    lse = torch.where(l == 0.0, torch.full_like(l, NEG_INF), m + torch.log(safe_l))
    return out, lse.reshape(b, h, sq)


def _flash_p_ds(q, k, v, do, lse, delta, masks, causal: bool, sm_scale: float):
    """What both backward kernels recompute, fp32 [B, KVH, G, Sq, Skv]:
    p = exp(s - lse) with masked p = 0, and dS = p (dO V^T - delta) scale."""
    b, h, sq, _ = q.shape
    kvh = k.shape[1]
    s, valid = _flash_scores(q, k, masks, causal, sm_scale)
    p = torch.exp(s - lse.reshape(b, kvh, h // kvh, sq, 1))
    if valid is not None:
        p = torch.where(valid, p, torch.zeros_like(p))
    dp = torch.einsum("bkgqd,bkcd->bkgqc", _grouped(do, kvh).float(), v.float())
    return p, p * (dp - delta.reshape(b, kvh, h // kvh, sq, 1)) * sm_scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, masks, causal: bool, sm_scale: float):
    """Plain version of the dQ kernel -> dq [B, H, Sq, D]: dQ = dS K with
    dS rounded to k's dtype. ``lse`` and ``delta`` are [B, H, Sq] fp32
    (delta = rowsum(dO * O), see :func:`flash_delta`)."""
    b, h, sq, d = q.shape
    _, ds = _flash_p_ds(q, k, v, do, lse, delta, masks, causal, sm_scale)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, h, sq, d).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, masks, causal: bool, sm_scale: float):
    """Plain version of the dK/dV kernel -> ``(dk, dv)`` [B, KVH, Skv, D]:
    dV = p^T dO with p in fp32, dK = dS^T q with dS rounded to q's dtype,
    both summed over each kv head's query-head group."""
    kvh = k.shape[1]
    p, ds = _flash_p_ds(q, k, v, do, lse, delta, masks, causal, sm_scale)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, _grouped(do, kvh).float())
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds.to(q.dtype).float(), _grouped(q, kvh).float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, Sq]: the backward kernels'
    per-row input, computed outside them as the reference does."""
    return (do.float() * out.float()).sum(dim=-1)


def _int_masks(kv_mask, q_segment_ids, kv_segment_ids):
    def as_int(t):
        return None if t is None else t.to(torch.int32).contiguous()

    return as_int(kv_mask), as_int(q_segment_ids), as_int(kv_segment_ids)


def _flash_blocks(q, k):
    if not _pick_block(q.shape[2]) or not _pick_block(k.shape[2]):
        raise ValueError(
            f"sequence lengths ({q.shape[2]}, {k.shape[2]}) need a 128-multiple block; "
            "pad inputs or use dot_product_attention (auto-fallback)"
        )


# The flash forward as one operator, ``torch.ops.accelerate_tpu_torch.flash_fwd``
# (the reference's ``_flash_core`` custom VJP): a name a selective-
# checkpoint policy can pick out of a checkpointed block, which sees
# operators, not Python functions (``save_dots``' policy, models/decoder.py,
# sees it as one operator and recomputes it). Its implementation calls
# ``kernels.flash_fwd``: the plain version on a CPU tensor, the bf16 or
# fp16 kernel on a CUDA one. Its backward runs the dQ and dK/dV kernels
# from q, k, v, out and lse.
@torch.library.custom_op("accelerate_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_mask: Optional[torch.Tensor], q_seg: Optional[torch.Tensor],
                 kv_seg: Optional[torch.Tensor], causal: bool,
                 sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    from . import kernels

    return kernels.flash_fwd(q, k, v, (kv_mask, q_seg, kv_seg), causal, sm_scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale):
    b, h, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, kv_mask, q_seg, kv_seg)
    ctx.causal, ctx.sm_scale = causal, sm_scale


def _flash_backward(ctx, do, dlse):
    from . import kernels

    q, k, v, out, lse, kv_mask, q_seg, kv_seg = ctx.saved_tensors
    masks = (kv_mask, q_seg, kv_seg)
    do = do.contiguous()
    delta = flash_delta(out, do)
    dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, masks, ctx.causal, ctx.sm_scale)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, masks, ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None, None, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup_context)


class _FlashReplay(torch.autograd.Function):
    """The flash operator's node rebuilt in a recompute from the out and
    lse its forward gave: the same saved tensors, the same backward, no
    forward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale, out, lse):
        _flash_setup_context(ctx, (q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale),
                             (out, lse))
        return out.clone()

    @staticmethod
    def backward(ctx, do):
        return (*_flash_backward(ctx, do, None), None, None)


class FlashResiduals:
    """What a checkpointed block keeps of its flash calls under remat
    ``save_attention`` (the reference's ``save_only_these_names
    ("flash_out", "flash_lse")``): ``recording()`` is the checkpoint's
    forward context, in which each call of :func:`flash_attention` keeps
    its out and lse; ``replaying()`` its recompute context, in which the
    calls take them back in order instead of running the forward kernel.
    Everything else of the block, q, k and v included, is recomputed.
    A pair of plain context managers for ``torch.utils.checkpoint``'s
    ``context_fn``, so no dispatch mode runs over the block's operators."""

    _active = threading.local()

    def __init__(self):
        self.saved: list = []
        self._next = 0

    @contextlib.contextmanager
    def _using(self, mode: str):
        prev = getattr(self._active, "state", None)
        self._active.state = (self, mode)
        try:
            yield
        finally:
            self._active.state = prev

    def recording(self):
        return self._using("record")

    def replaying(self):
        self._next = 0
        return self._using("replay")

    @classmethod
    def call(cls, q, k, v, kv_mask, q_seg, kv_seg, causal: bool, sm_scale: float):
        """The flash operator, kept or replayed when a block asks for it."""
        state = getattr(cls._active, "state", None)
        if state is None:
            return flash_fwd_op(q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale)[0]
        self, mode = state
        if mode == "record":
            out, lse = flash_fwd_op(q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale)
            self.saved.append((out.detach(), lse.detach()))
            return out
        out, lse = self.saved[self._next]
        self._next += 1
        return _FlashReplay.apply(q, k, v, kv_mask, q_seg, kv_seg, causal, sm_scale, out, lse)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention, differentiable. q [B, H, Sq, D]; k/v [B, KVH, Skv, D]
    (KVH divides H; K/V are never expanded). ``kv_mask`` [B, Skv]: nonzero
    may be attended. ``q_segment_ids`` / ``kv_segment_ids`` [B, S]: tokens
    attend only within equal ids. Sequence lengths are multiples of 128,
    as the reference's block choice asks. CUDA tensors run the kernels
    (bf16 or fp16), CPU tensors their plain versions, through
    :func:`flash_fwd_op`."""
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    h, kvh = q.shape[1], k.shape[1]
    if h % kvh:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads ({kvh})")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given together")
    _flash_blocks(q, k)
    kvm, qs, ks = _int_masks(kv_mask, q_segment_ids, kv_segment_ids)
    return FlashResiduals.call(q.contiguous(), k.contiguous(), v.contiguous(), kvm, qs, ks,
                               bool(causal), float(sm_scale))


def flash_attention_with_lse(
    q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
):
    """Forward only: ``(out, lse [B, H, Sq] fp32)`` from the forward
    kernel, for a caller that builds its own backward (the ring attention
    of ``parallel/context.py``) with :func:`flash_attention_bwd`."""
    from . import kernels

    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _flash_blocks(q, k)
    masks = _int_masks(kv_mask, None, None)
    return kernels.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), masks,
                             bool(causal), float(sm_scale))


def flash_attention_bwd(
    q, k, v, out, lse, do, *, causal: bool = False, sm_scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
):
    """``(dq, dk, dv)`` of one q/kv block pair given a (possibly global)
    lse [B, H, Sq]: with p = exp(s - lse) the partial gradients of several
    kv blocks sum to the whole, which is what a ring backward needs."""
    from . import kernels

    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _flash_blocks(q, k)
    masks = _int_masks(kv_mask, None, None)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = flash_delta(out, do)
    dq = kernels.flash_bwd_dq(q, k, v, do, lse, delta, masks, bool(causal), float(sm_scale))
    dk, dv = kernels.flash_bwd_dkv(q, k, v, do, lse, delta, masks, bool(causal),
                                   float(sm_scale))
    return dq, dk, dv


def flash_route(impl: str, device: torch.device, sq: int, skv: int, head_dim: int,
                has_bias: bool = False) -> bool:
    """Does :func:`dot_product_attention` take the flash kernels for these
    inputs? ``"flash"`` always (raising where it cannot), ``"xla"`` or a
    bias never; ``"auto"`` on a CUDA tensor exactly where the reference's
    TPU gate passes (sequence lengths with a 128-multiple block, head_dim
    % 128 == 0). What the kernels cannot take there (not bf16, a head_dim
    they were not built for) raises in their wrappers."""
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got {impl!r}")
    if impl == "xla" or has_bias:
        return False
    if impl == "flash":
        return True
    return (device.type == "cuda" and bool(_pick_block(sq)) and bool(_pick_block(skv))
            and head_dim % 128 == 0)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention dispatcher: the flash kernels where :func:`flash_route`
    says so, :func:`mha_reference` otherwise. Layout [B, H, S, D]. The
    plain path honours kv_mask and segment ids by folding them into the
    additive bias (NEG_INF where masked), as the reference does."""
    if impl == "flash" and bias is not None:
        raise ValueError(
            "flash impl does not support arbitrary bias; use kv_mask/segment_ids or impl='xla'"
        )
    if flash_route(impl, q.device, q.shape[2], k.shape[2], q.shape[-1],
                   has_bias=bias is not None):
        return flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, kv_mask=kv_mask,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        )
    parts = [] if bias is None else [bias]
    if kv_mask is not None:
        parts.append(torch.where(kv_mask[:, None, None, :] != 0, 0.0, NEG_INF))
    if q_segment_ids is not None:
        same = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        parts.append(torch.where(same, 0.0, NEG_INF))
    folded = sum(parts) if parts else None
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale, bias=folded)
