"""LLaMA-family causal decoder: serving, KV-cache generation and the
training step.

Counterpart of ``accelerate_tpu/models/decoder.py``. Parameters keep the
reference's layouts (``wq [E, H, D]``, ``wk``/``wv [E, KVH, D]``,
``wo [H, D, E]``, ``w_gate``/``w_up [E, M]``, ``w_down [M, E]``,
``embedding [V, E]``, ``lm_head [E, V]``) so converted weights load
without transposes. By default (serving) matmul weights and the embedding
are stored in the compute dtype (the reference casts them there at every
use, which rounds the same way) and norm weights stay fp32; training
passes ``param_dtype=torch.float32`` for fp32 master weights, which every
forward casts at use: matmul weights and the embedding to the compute
dtype as the reference model does, and every floating parameter first to
the Accelerator's compute dtype when its mixed precision sets one
(:meth:`DecoderLM.set_param_cast`, the reference's ``_cast_params``).

Training (``labels`` given, no cache): attention through
``ops/attention.dot_product_attention`` (the flash kernels under
``attention_impl="flash"``, or ``"auto"`` on CUDA where shapes allow),
then the final norm, the tied LM head and the fused chunked cross entropy
(``ops/losses.py``), returning ``{"loss": ...}``. With ``config.remat``
each block is checkpointed (``torch.utils.checkpoint``, the reference's
``_remat_policy``): ``"full"`` recomputes the whole block, the flash
forward included, in backward; ``"save_attention"`` keeps only the flash
operator's out and lse (``save_only_these_names("flash_out",
"flash_lse")``) and recomputes everything else, q, k and v included, so
the forward kernel runs once (``ops/attention.FlashResiduals``: the
checkpoint's forward and recompute contexts keep and replay the flash
operator's two outputs, with no dispatch mode over the block);
``"save_dots"`` keeps every projection matmul's output (``aten.mm`` /
``aten.addmm``, as ``dots_with_no_batch_dims_saveable`` keeps the dots
without batch dims) and recomputes the rest, the flash forward included:
a selective-checkpoint policy over the block's operators.

With ``config.use_fp8`` every projection (QKV, O and the MLP's three)
runs the fp8 recipe (``ops/fp8.py``: ``torch._scaled_mm`` on the card),
on every path: training, the five cache branches and the captured decode
steps (an MoE block's experts stay plain, as the reference's). A model
built with ``fp8_recipe="delayed"`` holds each projection's amax history
as a [2, H] fp32 buffer under the reference's name (``attn.wq_fp8`` ...
``attn.wo_fp8``, ``mlp.gate`` / ``up`` / ``down``; :meth:`_Model.
fp8_histories`): a cache-free forward reads them and, training, records
its amaxes (:meth:`_Model._arm_fp8`); a cached forward (generation,
serving) has none and runs current scaling, as the reference's apply of
``{"params": ...}`` alone.

Residual dropout (``config.dropout_rate``) follows the attention and the
MLP of every block, as the reference's, in training mode (``train()``,
the module's default) and only on the cache-free forward. Its masks
cannot be JAX's bits; they are drawn from a generator seeded with a hash
of (the keychain's seed, the ``"dropout"`` stream's counter, the layer,
the site): one key per training forward (``utils/random.next_key``), so
each micro-batch and update draws its own masks, and the recompute of a
checkpointed block draws the same ones again.

``DecoderAttention`` carries five cache branches. Caches are updated IN
PLACE (the reference returns new arrays; the port writes into the
tensors it is given).

Over the paged arena (per layer ``{"k", "v"}`` leaves of [num_pages,
KVH, page_size, D] in the compute dtype, or int8 payload pages
[num_pages, KVH, page_size, D or D / 2] beside ``{"k_scale",
"v_scale"}`` [num_pages, KVH, page_size, 1] fp32; page size and storage
are read from the leaves):

- slot-arena decode (``cache_positions`` + ``page_table``; S = 1, or
  K + 1 for a speculative verify step): scatter the fresh K/V through
  the page table (``quantize_kv`` on a quantized arena), then the paged
  decode read;
- packed ragged prefill (``ragged_slots`` + ``slot_hist``): the ragged
  prefill kernel (quantize-on-write fused on a quantized arena), then the
  scatter of payload and scales (pad rows land on parking page 0).

Over a dense cache (:meth:`DecoderLM.init_cache`: per layer ``{"k",
"v"}`` of [B, KVH, L, D] in the compute dtype, or int8 payloads
[B, KVH, L, D or D / 2] plus ``{"k_scale", "v_scale"}`` [B, KVH, L, 1]
fp32, and ``"index"``, the position the next single-stream write lands
at; the storage format is read from the leaves):

- whole-prompt prefill (no ``cache_positions``, ``decode=False``): write
  positions [0, S), set the index to S, and attend causally through
  ``dot_product_attention`` (the flash forward kernel where
  ``flash_route`` allows it); a quantized cache stores payload and scales
  and attends over the dequantized values, as the reference does;
- dense slot-arena decode (``cache_positions`` without ``page_table``):
  scatter at each batch row's own position(s), quantizing on write, then
  ``decode_attention`` with [B, S] positions (the dense decode kernel);
- single-stream decode / chunk (``decode=True``, no ``cache_positions``):
  write at the index, advance it, then ``decode_attention`` with
  positions ``index + arange(S)``.

With no cache the forward is the cache-free causal attention of
``dot_product_attention`` (the plain ``mha_reference`` unless the flash
kernels are chosen), used as the teacher-forced oracle.

Big-model dispatch (``big_modeling.py``) builds the model on the meta
device and binds its weights to what the tiers hold: device tensors
(rows of stacked leaves), :class:`StreamedWeight` for host-tier weights
(a block stages its own into shared device buffers before it runs, the
model its top-level ones) and ``QuantizedLayer`` views dequantized at
use. ``_use`` reads every weight through :func:`_resolve`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel.mesh import axis_index, axis_size
from ..ops.attention import (
    FlashResiduals,
    decode_attention,
    decode_attention_reference,
    dot_product_attention,
    paged_decode_attention,
    ragged_prefill_attention,
)
from ..ops import fp8
from ..ops.layers import apply_rotary_embedding, rms_norm, rotary_embedding_tables, swiglu
from ..ops.losses import fused_linear_cross_entropy_parts, mesh_mean
from ..utils.quantization import dequantize_kv, kv_cache_bits, quantize_kv
from ..utils.random import next_key
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


def _cache_bits(cache: dict, head_dim: int) -> int:
    """Storage bits of a cache's (dense or paged) K/V payload: 0 for the
    compute dtype, else 8 (int8) or 4 (int4, a D / 2 payload row)."""
    if "k_scale" not in cache:
        return 0
    return 4 if 2 * cache["k"].shape[-1] == head_dim else 8


def _resolve(p) -> torch.Tensor:
    """A weight as a tensor on the model's device. Big-model dispatch
    (``big_modeling.py``) binds weights that are not tensors: a host-tier
    weight's device buffer (:class:`StreamedWeight`), or a quantized
    layer dequantized at use (``utils/quantization.QuantizedLayer``);
    both give their tensor through ``weight()``."""
    return p if isinstance(p, torch.Tensor) else p.weight()


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._scaled_mm.default)  # the fp8 projections' (ops/fp8.py)


def _save_dots(ctx, op, *args, **kwargs):
    """``save_dots``' selective-checkpoint policy: keep the projection
    matmuls' outputs, recompute every other operator."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_contexts(policy: str):
    """``torch.utils.checkpoint``'s ``context_fn`` of ``remat_policy``
    (None for "full"): the forward and recompute contexts of one
    checkpointed block."""
    if policy == "save_attention":
        def contexts():
            kept = FlashResiduals()
            return kept.recording(), kept.replaying()

        return contexts
    if policy == "save_dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return None


def _mask_seed(seed: int, count: int, layer: int, site: int) -> int:
    """A 63-bit generator seed from a dropout mask's key: splitmix64 over
    its four parts in turn."""
    h = 0
    for part in (seed, count, layer, site):
        h = (h ^ (int(part) & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h >> 1


def dropout(y: torch.Tensor, rate: float, key: tuple, site: int) -> torch.Tensor:
    """The reference's ``nn.Dropout``: each entry kept with probability
    ``1 - rate`` and divided by it, else 0. ``key`` is ``(seed, count,
    layer)``; the mask is drawn from a fresh generator seeded with
    :func:`_mask_seed` (Philox on CUDA), so the same key and site give
    the same mask."""
    gen = torch.Generator(device=y.device)
    gen.manual_seed(_mask_seed(*key, site))
    keep = torch.rand(y.shape, generator=gen, device=y.device) >= rate
    return torch.where(keep, y / (1.0 - rate), torch.zeros((), dtype=y.dtype, device=y.device))


class StreamedWeight:
    """A weight that lives in host memory (pinned on CUDA) and is copied
    into a device buffer before the module that owns it runs.

    ``host`` is the host tensor (one layer's row of a stacked leaf, or a
    whole leaf), None for a disk-tier weight outside a call of its
    dispatched model; ``buffer`` is the device tensor every layer of the
    same weight kind shares, so the card holds one layer of it at a time.
    :meth:`stage` copies asynchronously on the current stream: the copy
    orders after the previous layer's use of the buffer, and a CUDA graph
    captures it."""

    def __init__(self, host: Optional[torch.Tensor], buffer: torch.Tensor):
        self.host, self.buffer = host, buffer

    def stage(self):
        if self.host is None:
            raise RuntimeError("a disk-tier weight is only loaded during a call of its "
                               "DispatchedModel (or generate_dispatched)")
        self.buffer.copy_(self.host, non_blocking=True)

    def weight(self) -> torch.Tensor:
        return self.buffer


class _Module(nn.Module):
    """Base of the decoder's modules: parameters made on one device, and
    the mixed-precision cast every parameter takes at use."""

    # the Accelerator's compute dtype (set_param_cast), None without one
    param_cast: Optional[torch.dtype] = None
    # during a training forward under a cast: id(parameter) -> its cast,
    # made once for the whole model (DecoderLM.forward)
    cast_of: Optional[dict] = None
    # host-tier weights to stage before this module runs (big-model
    # dispatch binds them: a block's own and its sublayers', or the
    # model's top-level ones)
    streamed: tuple = ()
    # the delayed fp8 recipe's view of the forward in progress
    # (ops/fp8.Fp8Forward), set by _Model._arm_fp8; None: no histories
    fp8_forward = None
    # the device mesh the model trains on (_Model.set_mesh), None on one
    # process
    mesh = None

    def _param(self, shape, device, dtype):
        return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))

    def _use(self, p, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``p`` as the forward reads it: rounded to the mixed-precision
        compute dtype if one is set (the training forward's one cast of
        it, when there is one), then to ``dtype`` if given."""
        p = _resolve(p)
        if self.param_cast is not None:
            cast = None if self.cast_of is None else self.cast_of.get(id(p))
            p = p.to(self.param_cast) if cast is None else cast
        return p if dtype is None else p.to(dtype)

    def _stage(self):
        for w in self.streamed:
            w.stage()

    def _remat(self, body, *args):
        """``body(*args)``, checkpointed per the config's ``remat_policy``
        (``torch.utils.checkpoint``; "full" where the config has none) when
        ``config.remat`` is on and gradients are recorded: a block of a
        training forward. The recompute reads the delayed fp8 view the
        forward read (a pipelined forward arms one per microbatch)."""
        cfg = self.config
        if not (cfg.remat and torch.is_grad_enabled()):
            return body(*args)
        contexts = _remat_contexts(getattr(cfg, "remat_policy", "full"))
        kw = {} if contexts is None else {"context_fn": contexts}
        view = self.fp8_forward
        if view is not None:
            inner = body

            def body(*a):
                _set_fp8_view(self, view)
                return inner(*a)
        return checkpoint(body, *args, use_reentrant=False, **kw)


def _set_fp8_view(module: nn.Module, view):
    """Give ``module`` and its submodules the delayed fp8 view ``view``
    (an ``ops/fp8.Fp8Forward``, or None)."""
    for m in module.modules():
        if isinstance(m, _Module):
            m.fp8_forward = view


class _Absent(nn.Module):
    """The place of a block that another rank of the ``stage`` group holds
    (a model on a stage mesh builds only its own stages' blocks): no
    parameters, never called."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this block lives on another rank of the stage group")


class DecoderAttention(_Module):
    """``causal=False`` (with a ``kv_mask``) is the bidirectional form the
    seq2seq encoder reuses (``models/seq2seq.py``): the same projections
    and RoPE, no cache. ``config`` may be a ``Seq2SeqConfig``: the cache
    branches read their storage format from the cache's leaves, and the
    one field that config lacks (the paged ragged prefill's
    ``prefill_kernel_block``) through ``getattr``, as the reference's do."""

    def __init__(self, config: DecoderConfig, device, param_dtype, causal: bool = True):
        super().__init__()
        e, h, kv, d = config.embed_dim, config.num_heads, config.num_kv_heads, config.head_dim
        self.config = config
        self.causal = causal
        self.wq = self._param((e, h, d), device, param_dtype)
        self.wk = self._param((e, kv, d), device, param_dtype)
        self.wv = self._param((e, kv, d), device, param_dtype)
        self.wo = self._param((h, d, e), device, param_dtype)
        fp8.register_histories(self, fp8.ATTENTION_HISTORIES, config, device)

    def qkv(self, x, sin, cos):
        """Projections and RoPE: x [B, S, E] -> q [B, H, S, D], k/v
        [B, KVH, S, D] (views of the projections, not contiguous); through
        the fp8 recipe (``ops/fp8.fp8_attn_proj``) under ``use_fp8``."""
        cfg = self.config
        e, h, kv, d, dt = cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.dtype
        b, s = x.shape[0], x.shape[1]
        if cfg.use_fp8:
            q = fp8.fp8_attn_proj(self, "wq_fp8", x, self._use(self.wq, dt), h, d, cfg)
            k = fp8.fp8_attn_proj(self, "wk_fp8", x, self._use(self.wk, dt), kv, d, cfg)
            v = fp8.fp8_attn_proj(self, "wv_fp8", x, self._use(self.wv, dt), kv, d, cfg)
        else:
            q = (x @ self._use(self.wq, dt).reshape(e, h * d)).reshape(b, s, h, d).transpose(1, 2)
            k = (x @ self._use(self.wk, dt).reshape(e, kv * d)).reshape(b, s, kv, d).transpose(1, 2)
            v = (x @ self._use(self.wv, dt).reshape(e, kv * d)).reshape(b, s, kv, d).transpose(1, 2)
        return apply_rotary_embedding(q, sin, cos), apply_rotary_embedding(k, sin, cos), v

    def project_out(self, out):
        """Attention output [B, H, S, D] -> [B, S, E]."""
        cfg = self.config
        if cfg.use_fp8:
            return fp8.fp8_attn_out(self, "wo_fp8", out, self._use(self.wo, cfg.dtype), cfg)
        b, h, s, d = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return out @ self._use(self.wo, cfg.dtype).reshape(h * d, cfg.embed_dim)

    def attend(self, q, k, v, kv_mask=None):
        """Cache-free attention (training, and the plain forward): causal,
        or bidirectional over ``kv_mask`` for an encoder. Causal attention
        without a mask on a mesh whose ``sequence`` axis is > 1 is ring
        attention over this rank's chunk (``parallel/context.py``), as the
        reference's."""
        impl = self.config.attention_impl
        if self.causal and kv_mask is None and axis_size(self.mesh, "sequence") > 1:
            from ..parallel.context import ring_attention_sharded

            return ring_attention_sharded(q, k, v, self.mesh, causal=True,
                                          impl="dense" if impl == "xla" else impl)
        return dot_product_attention(q, k, v, causal=self.causal, kv_mask=kv_mask, impl=impl)

    def forward(self, x, sin, cos, kv_mask=None, cache=None, cache_positions=None,
                page_table=None, ragged_slots=None, slot_hist=None, decode=False):
        q, k, v = self.qkv(x, sin, cos)
        if cache is None:
            out = self.attend(q, k, v, kv_mask)
        elif ragged_slots is not None:
            out = self._ragged_prefill(q, k, v, cache, cache_positions, page_table,
                                       ragged_slots, slot_hist)
        elif page_table is not None:
            out = self._paged_decode(q, k, v, cache, cache_positions, page_table)
        elif cache_positions is not None:
            out = self._slot_decode(q, k, v, cache, cache_positions)
        elif decode:
            out = self._stream_decode(q, k, v, cache)
        else:
            out = self._prefill(q, k, v, cache)
        return self.project_out(out)

    def _prefill(self, q, k, v, cache):
        """Whole-prompt prefill: the cache starts at 0, so plain causal
        attention over the fresh K/V stays on the flash path. A quantized
        cache stores payload + scales and attends over the DEQUANTIZED
        values: the stored cache is the source of truth, so this prefill
        agrees token for token with a chunked one that reads it back."""
        s = q.shape[2]
        length = cache["k"].shape[2]
        if s > length:
            raise ValueError(f"a {s}-token prefill does not fit the {length}-position cache")
        bits = _cache_bits(cache, self.config.head_dim)
        if bits:
            k_q, k_s = quantize_kv(k, bits)
            v_q, v_s = quantize_kv(v, bits)
            cache["k"][:, :, :s] = k_q
            cache["v"][:, :, :s] = v_q
            cache["k_scale"][:, :, :s] = k_s
            cache["v_scale"][:, :, :s] = v_s
            k = dequantize_kv(k_q, k_s, bits, q.dtype)
            v = dequantize_kv(v_q, v_s, bits, q.dtype)
        else:
            cache["k"][:, :, :s] = k
            cache["v"][:, :, :s] = v
        cache["index"] = s
        return dot_product_attention(q, k, v, causal=True, impl=self.config.attention_impl)

    def _slot_decode(self, q, k, v, cache, cache_positions):
        """Dense slot-arena decode: every batch row writes its fresh K/V at
        its own position(s), quantizing on write, then attends its own
        prefix. Stale entries past a row's frontier (a previous occupant,
        bucket padding) are overwritten before they are attended."""
        b, s = q.shape[0], q.shape[2]
        pos2d = cache_positions[:, None] if cache_positions.dim() == 1 else cache_positions
        if pos2d.shape[1] != s:
            raise ValueError(
                f"cache_positions covers {pos2d.shape[1]} positions per slot "
                f"but {s} tokens were fed"
            )
        rows = torch.arange(b, device=q.device)[:, None]
        pos_l = pos2d.long()
        k_new, v_new = k.transpose(1, 2), v.transpose(1, 2)  # [B, S, KVH, D]
        bits = _cache_bits(cache, self.config.head_dim)
        scale_kw = {}
        if bits:
            k_new, k_s = quantize_kv(k_new, bits)
            v_new, v_s = quantize_kv(v_new, bits)
            cache["k_scale"][rows, :, pos_l] = k_s
            cache["v_scale"][rows, :, pos_l] = v_s
            scale_kw = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                        "kv_quant_bits": bits}
        cache["k"][rows, :, pos_l] = k_new
        cache["v"][rows, :, pos_l] = v_new
        return decode_attention(q.contiguous(), cache["k"], cache["v"], q_positions=pos2d,
                                **scale_kw)

    def _stream_decode(self, q, k, v, cache):
        """Single-stream decode (S == 1, generate()'s loop) or a prefill
        chunk (S > 1, the flat engine's admission against a slot view):
        write at the cache index, advance it, attend positions
        ``index + arange(S)``."""
        s = q.shape[2]
        cur = int(cache["index"])
        length = cache["k"].shape[2]
        if cur + s > length:
            raise ValueError(
                f"writing {s} tokens at position {cur} overruns the {length}-position cache"
            )
        bits = _cache_bits(cache, self.config.head_dim)
        scale_kw = {}
        if bits:
            k, k_s = quantize_kv(k, bits)
            v, v_s = quantize_kv(v, bits)
            cache["k_scale"][:, :, cur:cur + s] = k_s
            cache["v_scale"][:, :, cur:cur + s] = v_s
            scale_kw = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                        "kv_quant_bits": bits}
        cache["k"][:, :, cur:cur + s] = k
        cache["v"][:, :, cur:cur + s] = v
        cache["index"] = cur + s
        positions = cur + torch.arange(s, device=q.device)
        if s == 1:
            return decode_attention(q.contiguous(), cache["k"], cache["v"],
                                    q_positions=positions, **scale_kw)
        # a prefill chunk: the reference forces the masked-dense read here
        # whatever the chunk size (accelerate_tpu/models/decoder.py:467-481),
        # so chunked prefill stays identical to whole-prompt prefill; its own
        # choice, not a fallback from the kernel
        return decode_attention_reference(q, cache["k"], cache["v"], positions,
                                          **scale_kw)

    def _ragged_prefill(self, q, k, v, cache, cache_positions, page_table,
                        ragged_slots, slot_hist):
        if q.shape[0] != 1:
            raise ValueError(
                f"packed ragged prefill packs all tails into one batch row; "
                f"got batch {q.shape[0]}"
            )
        row_pos = cache_positions[0] if cache_positions.dim() == 2 else cache_positions
        bits = _cache_bits(cache, self.config.head_dim)
        scale_kw = {}
        if bits:
            scale_kw = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                        "kv_quant_bits": bits}
        out, k_pay, k_scl, v_pay, v_scl = ragged_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), cache["k"], cache["v"],
            page_table=page_table, row_slot=ragged_slots, row_pos=row_pos,
            slot_hist=slot_hist, token_block=getattr(self.config, "prefill_kernel_block", None),
            **scale_kw,
        )
        # scatter payload (and scales) through the page table, in place.
        # Pad rows (-1) route to physical page 0, the parking page, whose
        # content is never read.
        ps = cache["k"].shape[2]
        valid = (ragged_slots >= 0) & (row_pos >= 0)
        srow = ragged_slots.long().clamp(min=0)
        spos = row_pos.long().clamp(min=0)
        page = torch.where(valid, page_table[srow, spos // ps].long(), 0)
        off = spos % ps
        cache["k"][page, :, off] = k_pay
        cache["v"][page, :, off] = v_pay
        if bits:
            cache["k_scale"][page, :, off] = k_scl
            cache["v_scale"][page, :, off] = v_scl
        return out

    def _paged_decode(self, q, k, v, cache, cache_positions, page_table):
        """Slot-arena decode over the paged arena (S = 1 a decode step,
        S = K + 1 a speculative verify step): every slot writes its fresh
        K/V at its own position(s), quantized with ``quantize_kv`` on a
        quantized arena (payload and scales at [page, :, off]), then the
        paged decode read."""
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
        k_new, v_new = k.transpose(1, 2), v.transpose(1, 2)  # [B, S, KVH, D]
        bits = _cache_bits(cache, self.config.head_dim)
        scale_kw = {}
        if bits:
            k_new, k_s = quantize_kv(k_new, bits)
            v_new, v_s = quantize_kv(v_new, bits)
            cache["k_scale"][page, :, off] = k_s
            cache["v_scale"][page, :, off] = v_s
            scale_kw = {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"],
                        "kv_quant_bits": bits}
        cache["k"][page, :, off] = k_new
        cache["v"][page, :, off] = v_new
        return paged_decode_attention(
            q.contiguous(), cache["k"], cache["v"], page_table=page_table,
            q_positions=pos2d, **scale_kw,
        )


class DecoderMLP(_Module):
    def __init__(self, config: DecoderConfig, device, param_dtype):
        super().__init__()
        e, m = config.embed_dim, config.mlp_dim
        self.config = config
        self.w_gate = self._param((e, m), device, param_dtype)
        self.w_up = self._param((e, m), device, param_dtype)
        self.w_down = self._param((m, e), device, param_dtype)
        fp8.register_histories(self, fp8.MLP_HISTORIES, config, device)

    def forward(self, x):
        cfg = self.config
        dt = cfg.dtype
        if cfg.use_fp8:
            gate = fp8.module_fp8_dot(self, "gate", x, self._use(self.w_gate, dt), cfg)
            up = fp8.module_fp8_dot(self, "up", x, self._use(self.w_up, dt), cfg)
            return fp8.module_fp8_dot(self, "down", swiglu(gate, up),
                                      self._use(self.w_down, dt), cfg)
        gate = x @ self._use(self.w_gate, dt)
        up = x @ self._use(self.w_up, dt)
        return swiglu(gate, up) @ self._use(self.w_down, dt)


class DecoderBlock(_Module):
    """Attention and MLP halves, each a residual. ``forward`` gives ``(x,
    aux)``: ``aux`` is the router's load-balancing loss when
    ``config.moe_num_experts`` > 1 (the MLP is then ``moe_mlp``,
    ``models/moe.py``), else 0.0."""

    def __init__(self, config: DecoderConfig, device, param_dtype, norm_dtype):
        super().__init__()
        self.config = config
        self.ln_attn = nn.Parameter(torch.ones(config.embed_dim, device=device, dtype=norm_dtype))
        self.ln_mlp = nn.Parameter(torch.ones(config.embed_dim, device=device, dtype=norm_dtype))
        self.attn = DecoderAttention(config, device, param_dtype)
        if config.moe_num_experts > 1:
            from .moe import MoeMLP

            self.moe_mlp = MoeMLP(config, device, param_dtype)
        else:
            self.mlp = DecoderMLP(config, device, param_dtype)

    def _norm(self, x, w):
        return rms_norm(x, self._use(w), self.config.norm_eps)

    def _body(self, x, sin, cos, kv_mask=None, drop=None, **cache_kw):
        """The block: attention and MLP halves, each a residual, with the
        residual dropout of ``drop`` (``(seed, count, layer)``) when given."""
        y = self.attn(self._norm(x, self.ln_attn), sin, cos, kv_mask=kv_mask, **cache_kw)
        if drop is not None:
            y = dropout(y, self.config.dropout_rate, drop, 0)
        x = x + y
        h = self._norm(x, self.ln_mlp)
        y, aux = self.moe_mlp(h) if self.config.moe_num_experts > 1 else (self.mlp(h), 0.0)
        if drop is not None:
            y = dropout(y, self.config.dropout_rate, drop, 1)
        return x + y, aux

    def forward(self, x, sin, cos, kv_mask=None, drop=None, **cache_kw):
        self._stage()
        if cache_kw.get("cache") is not None:
            return self._body(x, sin, cos, kv_mask, drop, **cache_kw)
        return self._remat(self._body, x, sin, cos, kv_mask, drop)


class _Model(_Module):
    """Base of the port's models (``DecoderLM``, ``Seq2SeqLM``,
    ``EncoderClassifier``): the mixed-precision cast, the one cast of every
    parameter a training forward makes, the embedding gather and weight
    loading."""

    def set_mesh(self, mesh):
        """Train over ``mesh`` (a ``DeviceMesh``, ``parallel/mesh.py``; None:
        one process): the loss becomes the mean over the global batch
        (``ops/losses.mesh_mean``) and a decoder's causal attention, on a
        ``sequence`` axis > 1, ring attention over the rank's chunk. On a
        ``stage`` axis > 1 a pipelined family (:attr:`pipeline_stack`)
        runs its stack over pipeline stages (``parallel/pipeline.py``) and
        keeps only its own stages' blocks. The ``tensor`` and ``expert``
        axes are not run yet."""
        from ..parallel.mesh import axis_size as size
        from ..utils.dataclasses import NEXT_PART

        bad = {a: size(mesh, a) for a in ("tensor", "expert") if size(mesh, a) > 1}
        if size(mesh, "stage") > 1:
            if self.pipeline_stack is None:
                bad["stage"] = size(mesh, "stage")
            elif size(mesh, "sequence") > 1:
                raise NotImplementedError(
                    f"a stage axis with a sequence axis: {NEXT_PART}")
        if bad:
            raise NotImplementedError(f"mesh axes {bad}: {NEXT_PART}")
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a torch DeviceMesh (parallel/mesh.py), got {mesh!r}")
        self.mesh = mesh
        self._plan = None
        if self.pipeline_stack is not None:
            stack = getattr(self, self.pipeline_stack)
            held = self.held_layers()
            for i in range(len(stack)):
                if i not in held and not isinstance(stack[i], _Absent):
                    stack[i] = _Absent()
        if self.sequence_ring:
            for m in self.modules():
                if isinstance(m, _Module):
                    m.mesh = mesh
        return self

    # whether the model's blocks see the mesh: a decoder's causal attention
    # rings over its sequence chunks; the bidirectional families gather the
    # whole sequence and attend over it as on one process
    sequence_ring = False
    # the ModuleList that runs over pipeline stages (DecoderLM's blocks,
    # Seq2SeqLM's decoder tower), None for a family without pipelining
    pipeline_stack: Optional[str] = None
    _plan = None

    def _stack_depth(self) -> int:
        cfg = self.config
        return cfg.num_decoder_layers if self.pipeline_stack == "decoder" else cfg.num_layers

    @property
    def num_stages(self) -> int:
        """Pipeline stages of the stack: an explicit ``pipeline_stages`` > 1,
        else the mesh's ``stage`` axis (``parallel/pipeline.
        effective_stages``); 1 unpipelined."""
        if self.pipeline_stack is None:
            return 1
        from ..parallel.pipeline import effective_stages

        return effective_stages(getattr(self.config, "pipeline_stages", 1), self._stack_depth(),
                                self.mesh)

    def stage_plan(self):
        """This process's ``parallel/pipeline.StagePlan``."""
        from ..parallel.pipeline import StagePlan

        if self._plan is None or self._plan.num_stages != self.num_stages:
            self._plan = StagePlan(self.num_stages, self.mesh)
        return self._plan

    def held_layers(self) -> range:
        """The stack's layers this process holds: all but on a stage axis,
        where its stages' L / S each."""
        n = self._stack_depth()
        if self.num_stages <= 1:
            return range(n)
        plan = self.stage_plan()
        per = n // plan.num_stages
        return range(plan.stages[0] * per, (plan.stages[-1] + 1) * per)

    def stage_blocks(self, stage: int) -> list:
        """``[(global layer index, block)]`` of pipeline stage ``stage``."""
        stack = getattr(self, self.pipeline_stack)
        per = len(stack) // self.num_stages
        return [(i, stack[i]) for i in range(stage * per, (stage + 1) * per)]

    def stage_param_ids(self) -> set:
        """ids of the parameters of the pipelined stack's held blocks (empty
        unpipelined): what the Accelerator reduces within a stage only."""
        if self.num_stages <= 1:
            return set()
        stack = getattr(self, self.pipeline_stack)
        return {id(p) for i in self.held_layers() for p in stack[i].parameters()}

    def rebuilt(self, config, mesh=None, state: Optional[dict] = None):
        """A model of this family over ``config`` (and ``mesh``), on this
        model's device, holding this model's tensors (``state``: the
        weights by name, this model's own when None), not copies: built on
        the meta device, then given the tensors (``load_state_dict(...,
        assign=True)``; a block the new model does not hold is left out).
        Frozen unless this model trains, with its mixed-precision cast."""
        trains = any(p.requires_grad for p in self.parameters())
        new = type(self)(config, device="meta",
                         param_dtype=next(self.parameters()).dtype if trains else None,
                         mesh=mesh)
        state = dict(self.state_dict()) if state is None else state
        new.load_state_dict(new.own_weights(state), strict=True, assign=True)
        new.device = self.device
        new.set_param_cast(self.param_cast)
        new.train(self.training)
        return new

    def own_weights(self, weights: dict) -> dict:
        """``weights`` without the blocks another rank of the stage group
        holds."""
        if self.pipeline_stack is None or self.num_stages <= 1:
            return weights
        prefix = self.pipeline_stack + "."
        held = {str(i) for i in self.held_layers()}
        return {k: v for k, v in weights.items()
                if not k.startswith(prefix) or k.split(".", 2)[1] in held}

    def set_param_cast(self, dtype: Optional[torch.dtype]):
        """Round every floating parameter to ``dtype`` at use (None: off).
        The Accelerator sets its mixed-precision compute dtype here."""
        for m in self.modules():
            if isinstance(m, _Module):
                m.param_cast = dtype
        return self

    # False while the Accelerator runs a user loss_fn: its forwards read
    # the amax histories and record nothing (the reference discards them)
    fp8_record: bool = True

    def load_params(self, params: dict):
        """Copy a weight dict (``models/convert.py``: numpy arrays or
        tensors, keyed like ``state_dict()``) into the module, casting to
        each parameter's dtype and device. Every weight must be given; an
        fp8 amax history the dict lacks keeps its value (state, not a
        weight: the reference's parameter tree has none)."""
        state = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
                 for k, v in self.own_weights(params).items()}
        for name, hist in self.fp8_histories().items():
            state.setdefault(name, hist)
        self.load_state_dict(state, strict=True)
        return self

    def fp8_histories(self) -> dict:
        """The delayed fp8 recipe's amax histories, ``{buffer name: [2, H]
        fp32}`` (empty without ``use_fp8`` and ``fp8_recipe="delayed"`` at
        build time): the reference's ``fp8_stats`` collection."""
        if not fp8.delayed(self.config):
            return {}
        return {name: buf for name, buf in self.named_buffers()
                if name.rsplit(".", 1)[-1] in fp8.HISTORY_NAMES}

    def _arm_fp8(self, cache_free: bool = True):
        """Open a forward's view of the amax histories (delayed fp8 only):
        a cache-free forward reads them, and records its amaxes when it
        trains (grad enabled, ``train()`` mode, no user loss_fn running); a
        cached forward (generation, serving) has none and runs current
        scaling, as the reference's apply of ``{"params": ...}`` alone."""
        if not fp8.delayed(self.config):
            return
        fwd = None
        if cache_free:
            fwd = fp8.Fp8Forward(self.fp8_record and self.training and torch.is_grad_enabled())
        for m in self.modules():
            if isinstance(m, _Module):
                m.fp8_forward = fwd

    def _arm_casts(self, cache_free: bool = True):
        """Start a forward: under a mixed-precision cast, a training forward
        (grad enabled, no cache) rounds every parameter once, as the
        reference's _cast_params: a parameter read twice (a tied embedding,
        or a block's weights in a remat recompute) then sums its gradients
        in the compute dtype before the one cast back, where a loss scale's
        overflow shows as the reference's does. Kept until the next
        forward: the backward's recomputes read the same casts. The last
        forward's casts go before the new ones are made, so two sets are
        never held at once."""
        self.release_casts()
        if self.param_cast is not None and torch.is_grad_enabled() and cache_free:
            cast_of = {id(p): p.to(self.param_cast) for p in self.parameters()
                       if p.is_floating_point()}
            for m in self.modules():
                if isinstance(m, _Module):
                    m.cast_of = cast_of

    def release_casts(self):
        """Drop the training forward's parameter casts (one compute-dtype
        copy of the weights): what a step that raised leaves behind."""
        for m in self.modules():
            if isinstance(m, _Module):
                m.cast_of = None

    def _gather(self, table, ids: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Rows ``ids`` of an embedding table as the forward reads them
        (:meth:`_use`), then in ``dtype`` if given: through the training
        forward's cast of the whole table when there is one (its gradient
        then sums in the compute dtype), else gathered and then cast (the
        same values as casting the whole table first)."""
        table = _resolve(table)
        if self.cast_of is not None:
            rows = self._use(table)[ids.long()]
            return rows if dtype is None else rows.to(dtype)
        return self._use(table[ids.long()], dtype)


class DecoderLM(_Model):
    """Causal LM: ``forward(input_ids, positions, ...) -> logits`` fp32, or
    ``{"loss": ...}`` when ``labels`` are given (training); an MoE model's
    training forward gives ``{"loss": lm + aux, "lm_loss", "aux_loss"}``,
    ``aux = moe_aux_loss_weight * (sum over layers) / num_layers``.

    ``cache`` is a list over layers of cache dicts, mutated in place: the
    paged arena (``serving/pages.init_paged_arena``) or a dense cache
    (:meth:`init_cache`, ``serving/arena.init_arena``); ``decode`` selects
    the single-stream step over a dense cache (see the module docstring).
    ``device=None`` means CUDA and raises without it; pass
    ``device="cpu"`` for the plain versions on the CPU. ``param_dtype``
    None stores matmul weights and the embedding in the compute dtype and
    norms in fp32, frozen (serving); a dtype stores every parameter in it,
    trainable (fp32 master weights for training). Parameters are created
    uninitialized: load them with ``models/convert.py``. ``mesh``: see
    :meth:`set_mesh`."""

    sequence_ring = True
    pipeline_stack = "layers"

    def __init__(self, config: DecoderConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None, mesh=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dt = param_dtype or config.dtype
        norm_dt = param_dtype or torch.float32
        self.embedding = self._param((config.vocab_size, config.embed_dim), self.device, dt)
        self.mesh = mesh
        held = self.held_layers()
        self.layers = nn.ModuleList(
            DecoderBlock(config, self.device, dt, norm_dt) if i in held else _Absent()
            for i in range(config.num_layers)
        )
        self.ln_final = nn.Parameter(
            torch.ones(config.embed_dim, device=self.device, dtype=norm_dt))
        self.lm_head = None
        if not config.tie_embeddings:
            self.lm_head = self._param((config.embed_dim, config.vocab_size), self.device, dt)
        if param_dtype is None:
            self.requires_grad_(False)
        self.set_mesh(mesh)

    def init_cache(self, batch: int, length: int, kv_cache_dtype: Optional[str] = None) -> list:
        """All-zeros dense KV cache for ``batch`` rows of ``length``
        positions: one dict per layer with ``"k"`` / ``"v"`` [B, KVH, L, D]
        in the compute dtype (``kv_cache_dtype`` "bf16"), or int8 payloads
        [B, KVH, L, D] ("int8") / [B, KVH, L, D / 2] ("int4") beside
        ``"k_scale"`` / ``"v_scale"`` [B, KVH, L, 1] fp32; and ``"index"``
        0. ``kv_cache_dtype`` None takes the config's."""
        cfg = self.config
        bits = kv_cache_bits(kv_cache_dtype or cfg.kv_cache_dtype)
        if bits == 4 and cfg.head_dim % 2:
            raise ValueError(f"int4 KV packing needs an even head_dim, got {cfg.head_dim}")
        rows = (batch, cfg.num_kv_heads, length)

        def zeros(width, dtype):
            return torch.zeros(rows + (width,), dtype=dtype, device=self.device)

        def layer():
            if bits == 16:
                return {"k": zeros(cfg.head_dim, cfg.dtype), "v": zeros(cfg.head_dim, cfg.dtype),
                        "index": 0}
            width = cfg.head_dim // 2 if bits == 4 else cfg.head_dim
            return {"k": zeros(width, torch.int8), "v": zeros(width, torch.int8),
                    "k_scale": zeros(1, torch.float32), "v_scale": zeros(1, torch.float32),
                    "index": 0}

        return [layer() for _ in range(cfg.num_layers)]

    def forward(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
                *, labels: Optional[torch.Tensor] = None, cache=None, cache_positions=None,
                page_table=None, ragged_slots=None, slot_hist=None, decode: bool = False,
                _piece=None):
        if _piece is not None:
            # one piece of the 1F1B schedule, run inside the root call
            # (parallel/pipeline.py): FSDP's hooks see a forward and its
            # backward as they do in gradient accumulation
            return _piece()
        cfg = self.config
        b, s = input_ids.shape
        if cache is not None and self.num_stages > 1:
            raise NotImplementedError(
                "KV-cache decode through the pipeline stages is not supported (a decode "
                "step is serial across stages by construction); use generation.generate "
                "or generation.depipeline(), which fold the stages back into one stack")
        if labels is not None and cache is not None:
            raise ValueError("labels (training loss) take the cache-free forward")
        if (cache_positions is not None or decode) and cache is None:
            raise ValueError("cache_positions and decode need a cache")
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
        self._stage()
        self._arm_casts(cache_free=cache is None)
        self._arm_fp8(cache_free=cache is None)
        x = self._gather(self.embedding, input_ids, cfg.dtype)
        if positions is None:
            # on a sequence axis this rank holds chunk i of n: its positions
            # are global
            chunk, _ = axis_index(self.mesh, ("sequence",))
            positions = chunk * s + torch.arange(s, device=input_ids.device)
        sin, cos = rotary_embedding_tables(positions, cfg.head_dim,
                                           theta=cfg.rope_theta, dtype=cfg.dtype)
        drop = None
        if cfg.dropout_rate > 0.0 and self.training and cache is None:
            drop = next_key("dropout")
        if self.num_stages > 1:
            return self._pipelined(x, sin, cos, drop, labels)
        moe_aux = 0.0  # router load balance, summed over layers
        for i, block in enumerate(self.layers):
            x, block_aux = block(
                x, sin, cos, drop=None if drop is None else (*drop, i),
                cache=None if cache is None else cache[i],
                cache_positions=cache_positions, page_table=page_table,
                ragged_slots=ragged_slots, slot_hist=slot_hist, decode=decode,
            )
            moe_aux = moe_aux + block_aux
        x = rms_norm(x, self._use(self.ln_final), cfg.norm_eps)
        head = self._head()
        if labels is not None:
            loss = self._head_ce_loss(x, head, labels)
            if cfg.moe_num_experts > 1:
                aux = cfg.moe_aux_loss_weight * moe_aux / cfg.num_layers
                return {"loss": loss + aux, "lm_loss": loss, "aux_loss": aux}
            return {"loss": loss}
        return (x @ head).float()

    def _head_ce_loss(self, x, head, labels):
        """HF convention, as the reference's ``_head_ce_loss``: labels ==
        input_ids, shifted here so position i predicts token i+1; mean CE
        over the targets that are not -100, through the fused chunked
        LM head. On a mesh the mean is over the global batch; on a
        ``sequence`` axis the shift is the global sequence's (a chunk's
        last position predicts the next chunk's first label, the last
        chunk's last position nothing)."""
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        if axis_size(self.mesh, "sequence") > 1:
            from ..parallel.context import next_chunk_first

            hidden = x.reshape(b * s, cfg.embed_dim)
            targets = torch.cat([labels[:, 1:], next_chunk_first(labels, self.mesh)[:, None]],
                                dim=1).reshape(b * s)
        else:
            hidden = x[:, :-1].reshape(b * (s - 1), cfg.embed_dim)
            targets = labels[:, 1:].reshape(b * (s - 1))
        total, count = fused_linear_cross_entropy_parts(
            hidden, head, targets, ignore_index=-100, num_chunks=cfg.fused_ce_chunks)
        return mesh_mean(total, count, self.mesh)

    # -- pipeline parallelism (parallel/pipeline.py) -----------------------

    def _head(self):
        """The LM head [E, V] as the forward reads it (the tied embedding's
        transpose, or ``lm_head``)."""
        cfg = self.config
        return (self._use(self.embedding, cfg.dtype).t() if cfg.tie_embeddings
                else self._use(self.lm_head, cfg.dtype))

    def _stage_fn(self, sin, cos, drop):
        """``(s, m, x) -> (y, aux)``: stage s's blocks on microbatch m,
        dropout keyed by (layer, microbatch) and, under the delayed fp8
        recipe, a view of the histories of its own (the reference carries
        them through the belt: each microbatch reads what the ones before
        it recorded)."""
        n = self.config.num_layers
        view = self.fp8_forward

        def run(s, m, x):
            blocks = self.stage_blocks(s)
            if view is not None:
                for _, block in blocks:
                    _set_fp8_view(block, fp8.Fp8Forward(view.record))
            aux = 0.0
            for i, block in blocks:
                x, a = block(x, sin, cos, drop=None if drop is None else (*drop, i + n * m))
                aux = aux + a
            return x, aux

        return run

    def _pipelined(self, x, sin, cos, drop, labels):
        """The GPipe forward over the stages (``parallel/pipeline.gpipe``):
        logits (every rank of the stage group gets the last stage's), or
        the training outputs, the loss the same on every rank."""
        from ..parallel.pipeline import (Handoff, adapt_microbatches, gpipe,
                                         merge_microbatches, split_microbatches)

        cfg = self.config
        _refuse_delayed_1f1b(cfg)
        b, s = x.shape[0], x.shape[1]
        plan = self.stage_plan()
        S = plan.num_stages
        M = adapt_microbatches(b, cfg.pipeline_microbatches or S, S)
        handoff = Handoff(plan, (b // M, s, cfg.embed_dim), cfg.dtype, x.device)
        inputs = list(split_microbatches(x, M).unbind(0)) if plan.first else None
        outs, aux, tail = gpipe(self._stage_fn(sin, cos, drop), inputs, M, plan, handoff)
        y = rms_norm(merge_microbatches(outs), self._use(self.ln_final), cfg.norm_eps) \
            if plan.last else None
        if labels is None:
            logits = (y @ self._head()).float() if plan.last else None
            return _from_last_stage(logits, (b, s, cfg.vocab_size), plan, x.device)
        if plan.last:
            hidden = y[:, :-1].reshape(b * (s - 1), cfg.embed_dim)
            targets = labels[:, 1:].reshape(b * (s - 1))
            total, count = fused_linear_cross_entropy_parts(
                hidden, self._head(), targets, ignore_index=-100, num_chunks=cfg.fused_ce_chunks)
        else:
            total = count = torch.zeros((), device=x.device)
        loss = pipeline_mean(total, count, self.mesh)
        if cfg.moe_num_experts > 1:
            # sum over (stage, microbatch) of per-microbatch means: M times
            # the whole batch's, so / M
            moe = cfg.moe_aux_loss_weight * _stage_sum(aux, plan, x.device) / (cfg.num_layers * M)
            return {"loss": tail(loss + moe), "lm_loss": loss.detach(), "aux_loss": moe.detach()}
        return {"loss": tail(loss)}

    def pipeline_value_and_grad(self):
        """The 1F1B schedule's value-and-grad (``config.pipeline_schedule ==
        "1f1b"`` on more than one stage; None otherwise, where autograd
        through the GPipe forward trains):
        ``vag(input_ids, labels, scale=None) -> outputs``. It accumulates
        the gradient of ``scale`` x the loss (1 when None: fp16 passes its
        loss scale, so the whole backward runs in the scaled domain) into
        the parameters' ``.grad`` and returns the outputs the training
        forward would (``{"loss"}``, an MoE model's ``{"loss", "lm_loss",
        "aux_loss"}``), detached, the same on every rank. Each microbatch's
        CE is weighted by its valid tokens' share of the GLOBAL count, so
        the summed loss is the forward's mean even with uneven -100
        padding. Dropout draws the forward's masks: one key per update, a
        mask per (layer, microbatch), the same in the rematerialized
        forward."""
        if self.config.pipeline_schedule != "1f1b" or self.num_stages <= 1:
            return None
        _refuse_delayed_1f1b(self.config)
        return self._one_f_one_b

    def _one_f_one_b(self, input_ids, labels, scale=None):
        from ..parallel.pipeline import adapt_microbatches, split_microbatches

        cfg = self.config
        b, s = input_ids.shape
        S = self.num_stages
        M = adapt_microbatches(b, cfg.pipeline_microbatches or S, S)
        self.release_casts()  # each piece casts at use (run_one_f_one_b)
        self._arm_fp8()
        drop = None
        if cfg.dropout_rate > 0.0 and self.training:
            drop = next_key("dropout")
        sin, cos = rotary_embedding_tables(torch.arange(s, device=input_ids.device),
                                           cfg.head_dim, theta=cfg.rope_theta, dtype=cfg.dtype)
        labels_mb = split_microbatches(labels, M)

        def head_total(m, y):
            h = rms_norm(y, self._use(self.ln_final), cfg.norm_eps)
            total, _ = fused_linear_cross_entropy_parts(
                h[:, :-1].reshape(-1, cfg.embed_dim), self._head(),
                labels_mb[m][:, 1:].reshape(-1), ignore_index=-100,
                num_chunks=cfg.fused_ce_chunks)
            return total

        return run_one_f_one_b(
            self, M, (b // M, s, cfg.embed_dim), lambda: split_microbatches(
                self._gather(self.embedding, input_ids, cfg.dtype), M),
            self._stage_fn(sin, cos, drop), head_total,
            # position i predicts token i + 1: column 0 never counts
            (labels_mb[:, :, 1:] != -100).sum(), scale)


def run_one_f_one_b(model, M: int, shape: tuple, embed, run, head_total, count,
                    scale) -> dict:
    """The 1F1B value-and-grad of a pipelined model (``DecoderLM`` or
    ``Seq2SeqLM``'s decoder tower; ``parallel/pipeline.one_f_one_b``).
    ``embed()`` gives stage 0's input [M, *shape] with its graph (the
    embedding, and a seq2seq's encoder), ``run(s, m, x) -> (y, aux)`` stage
    s, ``head_total(m, y)`` the summed CE of microbatch m; ``count`` is
    this rank's valid targets. Each piece runs inside the model's own call
    (``forward(..., _piece=...)``), so FSDP's hooks see forwards and
    backwards as in gradient accumulation. No step-long copy of the weights
    in the compute dtype is kept (``_arm_casts``): a piece casts what it
    reads at use, so it holds its own stage's copy only while it runs, and
    every piece's gradients add into the fp32 ``.grad`` (the reference's
    schedule sums its stage gradients in fp32 too). Returns the outputs,
    detached, the same on every rank."""
    from ..parallel.pipeline import Handoff, one_f_one_b

    cfg = model.config
    plan = model.stage_plan()
    dev = next(model.parameters()).device
    seed = 1.0 if scale is None else float(scale)
    count, data = _global_count(count, model.mesh)
    moe = getattr(cfg, "moe_num_experts", 0) > 1
    aux_w = cfg.moe_aux_loss_weight / (cfg.num_layers * M) if moe else 0.0
    state = {"loss": torch.zeros((), device=dev), "aux": torch.zeros((), device=dev)}

    def forward(st, m, x):
        def piece():
            with torch.no_grad():
                y, a = run(st, m, x)
            if moe:
                state["aux"] += a
            return y
        return model(None, _piece=piece)

    def backward(st, m, x, cot):
        def piece():
            xg = x.detach().requires_grad_()
            with torch.enable_grad():
                y, a = run(st, m, xg)
                outs, grads = [y], [cot]
                if moe:
                    outs.append(a)
                    grads.append(torch.full_like(a, aux_w * seed))
                torch.autograd.backward(outs, grads)
            return xg.grad
        return model(None, _piece=piece)

    def head(m, y):
        def piece():
            yg = y.detach().requires_grad_()
            with torch.enable_grad():
                total = head_total(m, yg)
                (total * (data * seed) / count).backward()
            state["loss"] += total.detach() / count
            return yg.grad
        return model(None, _piece=piece)

    belt, inputs = None, None
    try:
        if plan.first:
            belt = model(None, _piece=embed)
            inputs = [t.detach() for t in belt.unbind(0)]
        handoff = Handoff(plan, shape, cfg.dtype, dev)
        dx, stats = one_f_one_b(forward, backward, head, inputs, M, plan, handoff)
        if plan.first:
            torch.autograd.backward(belt, torch.stack(dx))
    finally:
        model.release_casts()
    model.last_schedule = stats
    loss = _world_sum(state["loss"], model.mesh)
    if moe:
        aux = cfg.moe_aux_loss_weight * _stage_sum(state["aux"], plan, dev) / (cfg.num_layers * M)
        return {"loss": loss + aux, "lm_loss": loss, "aux_loss": aux}
    return {"loss": loss}


def _refuse_delayed_1f1b(cfg):
    """The reference's refusal of delayed fp8 under the 1f1b schedule,
    where the stages come from the mesh (the config refuses an explicit
    ``pipeline_stages``)."""
    if fp8.delayed(cfg) and cfg.pipeline_schedule == "1f1b":
        from .configs import DELAYED_1F1B

        raise NotImplementedError(DELAYED_1F1B)


def _global_count(count: torch.Tensor, mesh) -> tuple:
    """(the valid-token count over the global batch, fp32; the data
    group's size D): on a mesh, ``count`` summed over the ranks of this
    rank's stage (each stage's ranks together hold every row once). The
    loss a rank backwards is scaled by D, so the mean of the D ranks'
    gradients within a stage is the global one."""
    count = count.float()
    if mesh is None or mesh.size() == 1:
        return count.clamp(min=1.0), 1
    import torch.distributed as dist

    from ..parallel.sharding import data_group

    group, d = data_group(mesh)
    count = count.clone()
    dist.all_reduce(count, group=group)
    return count.clamp(min=1.0), d


def _world_sum(value: torch.Tensor, mesh) -> torch.Tensor:
    """``value`` summed over every rank (a quantity only the last stage's
    ranks hold: the others give 0)."""
    if mesh is None or mesh.size() == 1:
        return value
    import torch.distributed as dist

    value = value.detach().clone()
    dist.all_reduce(value)
    return value


def _stage_sum(aux, plan, device):
    """``aux`` (this rank's stages' part, with its graph) plus the other
    stage-group ranks' parts (values only): the whole stack's."""
    aux = aux if isinstance(aux, torch.Tensor) else torch.zeros((), device=device)
    if plan.group is None:
        return aux
    import torch.distributed as dist

    total = aux.detach().float().clone()
    dist.all_reduce(total, group=plan.group)
    return aux + (total - aux).detach()


def pipeline_mean(total: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """``ops/losses.mesh_mean`` on a mesh that may have a ``stage`` axis:
    the value is the global mean (only the last stage's ranks give a total
    and a count, the others zeros), and the gradient this rank's total x D
    / that count, D the ranks of its stage, over which the blocks'
    gradients are averaged."""
    from ..parallel.mesh import axis_size as size

    if mesh is None or mesh.size() == 1:
        return total / count.clamp(min=1.0)
    import torch.distributed as dist

    both = torch.stack([total.detach().float(), count.detach().float()])
    dist.all_reduce(both)
    denom = both[1].clamp(min=1.0)
    local = total * (mesh.size() // size(mesh, "stage")) / denom
    return local + (both[0] / denom - local).detach()


def _from_last_stage(value, shape, plan, device):
    """The last stage's ``value`` on every rank of the stage group (a
    broadcast from its owner); ``value`` itself on one process."""
    if plan.group is None:
        return value
    import torch.distributed as dist

    if value is None:
        value = torch.empty(shape, dtype=torch.float32, device=device)
    dist.broadcast(value, group=plan.group, group_src=plan.owner(plan.num_stages - 1))
    return value
