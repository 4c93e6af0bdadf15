"""LLaMA-family causal decoder for the paged serving path.

Counterpart of ``accelerate_tpu/models/decoder.py``. Parameters keep the
reference's layouts (``wq [E, H, D]``, ``wk``/``wv [E, KVH, D]``,
``wo [H, D, E]``, ``w_gate``/``w_up [E, M]``, ``w_down [M, E]``,
``embedding [V, E]``, ``lm_head [E, V]``) so converted weights load
without transposes. Matmul weights and the embedding are stored in the
compute dtype (the reference casts them there at every use, which rounds
the same way); norm weights stay fp32.

``DecoderAttention`` carries two cache branches, both over the paged
arena (per layer ``{"k", "v"}`` leaves of [num_pages, KVH, page_size, D],
updated IN PLACE; the page size is read from the leaves):

- slot-arena decode (``cache_positions`` + ``page_table``): scatter the
  fresh K/V through the page table, then the paged decode read;
- packed ragged prefill (``ragged_slots`` + ``slot_hist``): the ragged
  prefill kernel, then the scatter (pad rows land on parking page 0).

With no cache the forward is the plain causal attention
(``mha_reference``), used as the teacher-forced oracle. Every other
reference branch raises ``NotImplementedError`` naming its later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import (
    mha_reference,
    paged_decode_attention,
    ragged_prefill_attention,
)
from ..ops.layers import apply_rotary_embedding, rms_norm, rotary_embedding_tables, swiglu
from .configs import DecoderConfig


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raise when CUDA is asked for and absent: the
    port never moves to the CPU on its own (pass ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def _later(what: str, where: str):
    raise NotImplementedError(f"{what} belongs to a later slice of the port ({where})")


class DecoderAttention(nn.Module):
    def __init__(self, config: DecoderConfig, device, param_dtype):
        super().__init__()
        e, h, kv, d = config.embed_dim, config.num_heads, config.num_kv_heads, config.head_dim
        self.config = config

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=param_dtype),
                                requires_grad=False)

        self.wq, self.wk, self.wv = p(e, h, d), p(e, kv, d), p(e, kv, d)
        self.wo = p(h, d, e)

    def forward(self, x, sin, cos, cache=None, cache_positions=None,
                page_table=None, ragged_slots=None, slot_hist=None):
        cfg = self.config
        e, h, kv, d = cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        b, s = x.shape[0], x.shape[1]
        q = (x @ self.wq.reshape(e, h * d)).reshape(b, s, h, d).transpose(1, 2)
        k = (x @ self.wk.reshape(e, kv * d)).reshape(b, s, kv, d).transpose(1, 2)
        v = (x @ self.wv.reshape(e, kv * d)).reshape(b, s, kv, d).transpose(1, 2)
        q = apply_rotary_embedding(q, sin, cos)
        k = apply_rotary_embedding(k, sin, cos)

        if cache is None:
            if cfg.attention_impl == "flash":
                _later("flash attention (training forward)", "ROADMAP queue 2, kernels 1-3")
            out = mha_reference(q, k, v, causal=True)
        elif page_table is None or cache_positions is None:
            _later("the flat (non-paged) KV cache and whole-prompt prefill",
                   "ROADMAP queue 1, generate()")
        elif ragged_slots is not None:
            out = self._ragged_prefill(q, k, v, cache, cache_positions, page_table,
                                       ragged_slots, slot_hist)
        else:
            out = self._paged_decode(q, k, v, cache, cache_positions, page_table)
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return out @ self.wo.reshape(h * d, e)

    def _ragged_prefill(self, q, k, v, cache, cache_positions, page_table,
                        ragged_slots, slot_hist):
        if q.shape[0] != 1:
            raise ValueError(
                f"packed ragged prefill packs all tails into one batch row; "
                f"got batch {q.shape[0]}"
            )
        row_pos = cache_positions[0] if cache_positions.dim() == 2 else cache_positions
        out, k_pay, _, v_pay, _ = ragged_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), cache["k"], cache["v"],
            page_table=page_table, row_slot=ragged_slots, row_pos=row_pos,
            slot_hist=slot_hist, token_block=self.config.prefill_kernel_block,
        )
        # scatter through the page table, in place. Pad rows (-1) route to
        # physical page 0, the parking page, whose content is never read.
        ps = cache["k"].shape[2]
        valid = (ragged_slots >= 0) & (row_pos >= 0)
        srow = ragged_slots.long().clamp(min=0)
        spos = row_pos.long().clamp(min=0)
        page = torch.where(valid, page_table[srow, spos // ps].long(), 0)
        off = spos % ps
        cache["k"][page, :, off] = k_pay
        cache["v"][page, :, off] = v_pay
        return out

    def _paged_decode(self, q, k, v, cache, cache_positions, page_table):
        b, s = q.shape[0], q.shape[2]
        pos2d = cache_positions[:, None] if cache_positions.dim() == 1 else cache_positions
        if pos2d.shape[1] != s:
            raise ValueError(
                f"cache_positions covers {pos2d.shape[1]} positions per slot "
                f"but {s} tokens were fed"
            )
        # scatter the fresh K/V at each slot's own position(s) BEFORE the
        # read, in place: stale entries past a slot's frontier are always
        # overwritten before they are attended
        ps = cache["k"].shape[2]
        pos_l = pos2d.long()
        rows = torch.arange(b, device=q.device)[:, None]
        page = page_table[rows, pos_l // ps].long()  # [B, S]
        off = pos_l % ps
        cache["k"][page, :, off] = k.transpose(1, 2)  # [B, S, KVH, D]
        cache["v"][page, :, off] = v.transpose(1, 2)
        return paged_decode_attention(
            q.contiguous(), cache["k"], cache["v"], page_table=page_table,
            q_positions=pos2d,
        )


class DecoderMLP(nn.Module):
    def __init__(self, config: DecoderConfig, device, param_dtype):
        super().__init__()
        e, m = config.embed_dim, config.mlp_dim
        self.config = config

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=param_dtype),
                                requires_grad=False)

        self.w_gate, self.w_up, self.w_down = p(e, m), p(e, m), p(m, e)

    def forward(self, x):
        return swiglu(x @ self.w_gate, x @ self.w_up) @ self.w_down


class DecoderBlock(nn.Module):
    def __init__(self, config: DecoderConfig, device, param_dtype):
        super().__init__()
        self.config = config
        self.ln_attn = nn.Parameter(torch.ones(config.embed_dim, device=device),
                                    requires_grad=False)
        self.ln_mlp = nn.Parameter(torch.ones(config.embed_dim, device=device),
                                   requires_grad=False)
        self.attn = DecoderAttention(config, device, param_dtype)
        self.mlp = DecoderMLP(config, device, param_dtype)

    def forward(self, x, sin, cos, **cache_kw):
        y = rms_norm(x, self.ln_attn, self.config.norm_eps)
        x = x + self.attn(y, sin, cos, **cache_kw)
        y = rms_norm(x, self.ln_mlp, self.config.norm_eps)
        return x + self.mlp(y)


class DecoderLM(nn.Module):
    """Causal LM: ``forward(input_ids, positions, ...) -> logits`` fp32.

    ``cache`` is the paged arena (a list over layers of ``{"k", "v"}``
    tensors, see ``serving/pages.init_paged_arena``), mutated in place.
    ``device=None`` means CUDA and raises without it; pass
    ``device="cpu"`` for the plain versions on the CPU. Parameters are
    created uninitialized: load them with ``models/convert.py``."""

    def __init__(self, config: DecoderConfig, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dt = config.dtype
        self.embedding = nn.Parameter(
            torch.empty(config.vocab_size, config.embed_dim, device=self.device, dtype=dt),
            requires_grad=False)
        self.layers = nn.ModuleList(
            DecoderBlock(config, self.device, dt) for _ in range(config.num_layers)
        )
        self.ln_final = nn.Parameter(torch.ones(config.embed_dim, device=self.device),
                                     requires_grad=False)
        self.lm_head = None
        if not config.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(config.embed_dim, config.vocab_size, device=self.device, dtype=dt),
                requires_grad=False)

    def load_params(self, params: dict):
        """Copy a weight dict (``models/convert.py``: numpy arrays or
        tensors, keyed like ``state_dict()``) into the module, casting to
        each parameter's dtype and device. Every weight must be given."""
        state = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
                 for k, v in params.items()}
        self.load_state_dict(state, strict=True)
        return self

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                *, cache=None, cache_positions=None, page_table=None,
                ragged_slots=None, slot_hist=None) -> torch.Tensor:
        cfg = self.config
        b, s = input_ids.shape
        if page_table is not None and cache_positions is None:
            raise ValueError("page_table (paged slot-arena decode) requires cache_positions")
        if (ragged_slots is not None) != (slot_hist is not None):
            raise ValueError(
                "ragged_slots and slot_hist (packed ragged prefill) must be set together"
            )
        if ragged_slots is not None and page_table is None:
            raise ValueError(
                "ragged_slots (packed ragged prefill) requires page_table and cache_positions"
            )
        x = self.embedding[input_ids.long()].to(cfg.dtype)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)
        sin, cos = rotary_embedding_tables(positions, cfg.head_dim,
                                           theta=cfg.rope_theta, dtype=cfg.dtype)
        for i, block in enumerate(self.layers):
            x = block(
                x, sin, cos, cache=None if cache is None else cache[i],
                cache_positions=cache_positions, page_table=page_table,
                ragged_slots=ragged_slots, slot_hist=slot_hist,
            )
        x = rms_norm(x, self.ln_final, cfg.norm_eps)
        head = self.embedding.t() if cfg.tie_embeddings else self.lm_head
        return (x @ head).float()
