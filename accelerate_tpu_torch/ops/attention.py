"""Attention for the paged serving path: plain PyTorch versions and the
dispatch to the hand-written Hopper kernels.

Counterpart of ``accelerate_tpu/ops/attention.py``. Layouts match the
reference's public functions: q [B, H, S, D], k/v [B, KVH, S, D], paged
K/V leaves [num_pages, KVH, page_size, D], page tables [B, P] int32.
Query head ``h`` reads kv head ``h // group``, so K/V are never expanded.

Each kernel sits beside its plain version:

- :func:`paged_decode_attention` -> ``ops/kernels.paged_decode``
  (csrc/paged_decode.cu); plain version :func:`paged_decode_reference`.
- :func:`ragged_prefill_attention` -> ``ops/kernels.ragged_prefill``
  (csrc/ragged_prefill.cu); plain version :func:`ragged_prefill_reference`.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. Nothing falls back from the device to the plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() semantics with no NaN risk

# default packed-prefill token block: each admission tail pads to this
PREFILL_TOKEN_BLOCK = 8
# widest multi-query decode the kernel takes (decode 1, speculative verify K+1)
DECODE_KERNEL_MAX_SQ = 16


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


def paged_decode_reference(q, k_pages, v_pages, page_table, q_positions, sm_scale):
    """Plain paged decode: gather each slot's pages into position order,
    then the masked-dense read."""
    k_full = gather_kv_pages(k_pages, page_table)
    v_full = gather_kv_pages(v_pages, page_table)
    return decode_attention_dense(
        q, k_full, v_full, q_positions=q_positions, sm_scale=sm_scale
    )


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
) -> torch.Tensor:
    """Decode attention reading K/V through a per-slot page table.

    q [B, H, Sq, D]; k_pages/v_pages [NP, KVH, ps, D]; ``page_table``
    [B, P] int32; ``q_positions`` [B, Sq] (or [Sq]) global positions. On a
    CUDA tensor the paged decode kernel walks each slot's live pages
    straight from the arena; on a CPU tensor the plain gather + masked
    dense read runs."""
    from . import kernels

    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    pos = _positions_2d(q_positions, q.shape[0])
    return kernels.paged_decode(q, k_pages, v_pages, page_table, pos, scale)


def ragged_prefill_reference(q, k_new, v_new, k_pages, v_pages, page_table,
                             row_slot, row_pos, slot_hist, scale):
    """Plain packed ragged prefill: per-row gathered arena context plus the
    packed fresh K/V, masked exactly as the kernel masks, fp32 softmax.
    Pad rows (slot or position -1) output exactly 0. Returns
    ``(out [1, H, CAP, D], k_payload, None, v_payload, None)`` with the
    payloads token-major [CAP, KVH, D] for the caller's arena scatter."""
    _, h, cap, d = q.shape
    kvh = k_pages.shape[1]
    group = h // kvh
    row_slot = row_slot.long()
    row_pos = row_pos.long()
    slot_hist = slot_hist.long()
    kn_t = k_new[0].transpose(0, 1)  # [CAP, KVH, D]
    vn_t = v_new[0].transpose(0, 1)
    k_ctx = gather_kv_pages(k_pages, page_table)  # [S, KVH, L, D]
    v_ctx = gather_kv_pages(v_pages, page_table)
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
    kf = k_new[0]  # [KVH, CAP, D]
    vf = v_new[0]
    s_new = torch.einsum("kgrd,kcd->kgrc", qg.float(), kf.float()) * scale
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
    return out, kn_t, None, vn_t, None


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
):
    """Packed ragged prefill attention over the paged KV arena.

    q/k_new/v_new [1, H|KVH, CAP, D]: the packed fresh tails of every
    admission in this dispatch (post-RoPE). ``row_slot``/``row_pos`` [CAP]
    int32 map each packed row to its (slot, absolute position); -1 marks
    padding. Rows of one slot are contiguous, position-ordered and
    token-block aligned (the packer's contract). ``slot_hist`` [S] int32
    is each slot's live prefix already in the arena. Each row attends its
    slot's arena prefix ``[0, hist)`` plus the packed fresh rows of the
    same slot at or below its own position.

    Returns ``(out [1, H, CAP, D], k_payload, None, v_payload, None)``,
    payloads token-major [CAP, KVH, D] (the scale slots stay None until
    the quantized arena is ported). A CUDA tensor launches the ragged
    prefill kernel; a CPU tensor runs :func:`ragged_prefill_reference`."""
    from . import kernels

    b, h, cap, d = q.shape
    if b != 1:
        raise ValueError(f"packed ragged prefill takes batch 1, got {b}")
    bt = int(token_block or PREFILL_TOKEN_BLOCK)
    if cap % bt:
        raise ValueError(
            f"packed capacity {cap} must be a multiple of the token block {bt}"
        )
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    return kernels.ragged_prefill(
        q, k_new, v_new, k_pages, v_pages, page_table,
        row_slot.to(torch.int32), row_pos.to(torch.int32),
        slot_hist.to(torch.int32), scale, bt,
    )
