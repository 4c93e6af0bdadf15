"""T5-family encoder-decoder LM: training, and cached generation with the
encoder's K/V frozen at prefill.

Counterpart of ``accelerate_tpu/models/seq2seq.py``. The blocks are the
decoder's modules (``models/decoder.py``): ``DecoderAttention`` with
``causal=False`` and the source padding as ``kv_mask`` in the encoder,
causal with a KV cache in the decoder, and ``DecoderMLP``; so parameters
keep the reference's layouts and names (``encoder.{i}.attn.wq`` is the
reference's ``encoder/layers/block/attn/wq`` row ``i``,
``models/convert.py``). The decoder adds cross-attention
(:class:`CrossAttention`): decoder queries over the encoder's keys and
values, non-causal, the source padding as ``kv_mask``, no RoPE.

Attention at T5's head_dim 64 is the plain ``mha_reference`` through
``ops/attention.dot_product_attention`` on both sides: the reference takes
its flash kernel only where head_dim is a multiple of 128, and so does the
port's ``flash_route``. The one kernel on this model's path is the dense
decode kernel (``csrc/dense_decode.cu``, its D 64 instantiation), which
every cached decode step's self-attention runs.

The cache (:meth:`Seq2SeqLM.init_cache`) is a list over decoder layers of
``{"self": {"k", "v", "index"}, "cross": {"k", "v", "mask"}}``: the
self-attention's [B, KVH, max_cache_len, D] cache in the compute dtype,
and the cross-attention's [B, KVH, max_seq_len, D] K/V with the [B,
max_seq_len] source mask, zero-padded past the source and masked, as the
reference's ``cross_key`` / ``cross_value`` / ``cross_mask``. Fixed
buffers let generation capture the decode step as one CUDA graph
(``generation.generate_seq2seq``). :meth:`Seq2SeqLM.decode` is the prefill
with ``cache`` and no ``cache_positions`` (self-attention cache written at
[0, S), the cross K/V computed from ``encoder_states`` and frozen) and a
decode step with ``cache_positions`` (each row's token written at its
position, the dense decode read; the cross K/V read from the cache). The
cache stores the compute dtype only: the reference's seq2seq cache has no
quantized form (its config has no ``kv_cache_dtype``).

With ``config.use_fp8`` every projection, the cross-attention's too,
runs the fp8 recipe (``ops/fp8.py``); the delayed recipe's histories are
read and recorded by ``forward`` only: ``encode`` and ``decode`` are the
inference calls and run current scaling, as the reference's generation.

Training (``forward`` with ``labels``) runs the fused chunked LM-head
cross entropy over the decoder's hidden states, labels aligned 1:1 with
decoder positions, -100 ignored; the decoder inputs default to
:func:`shift_right` of the labels. Remat and residual dropout are the
decoder's (``config.remat_policy``; masks from the keychain's
``"dropout"`` stream, the encoder's blocks at layers 0..N-1 and the
decoder's at N..N+M-1, so no two blocks share a mask). Dropout runs in
``forward`` in training mode only; ``encode`` and ``decode`` are the
inference calls, deterministic as the reference's defaults.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops import fp8
from ..ops.attention import dot_product_attention
from ..ops.layers import rms_norm, rotary_embedding_tables
from ..ops.losses import fused_linear_cross_entropy_parts, mesh_mean
from ..parallel.context import gather_sequence
from ..parallel.mesh import axis_size
from ..utils.random import next_key
from .configs import DELAYED_1F1B
from .decoder import (
    DecoderAttention,
    _Absent,
    _from_last_stage,
    _refuse_delayed_1f1b,
    _set_fp8_view,
    pipeline_mean,
    run_one_f_one_b,
    DecoderMLP,
    _Model,
    _Module,
    _resolve,
    dropout,
    resolve_device,
)


@dataclass
class Seq2SeqConfig:
    """T5-family encoder-decoder config: the reference's field names and
    defaults, with torch dtypes. The defaults are t5-base: 12 + 12 layers,
    E 768, 12 heads of D 64, M 2048, vocab 32128. The fp8 knobs are the
    decoder's (``ops/fp8.py``); pipelining is accepted as a field, so a
    reference config carries over, and raises ``NotImplementedError``
    until its slice is ported."""

    vocab_size: int = 32_128
    num_layers: int = 12  # encoder depth
    num_decoder_layers: Optional[int] = None  # None -> num_layers
    embed_dim: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # None -> MHA
    head_dim: Optional[int] = None  # None -> embed_dim // num_heads
    mlp_dim: Optional[int] = None  # None -> ~8/3 * embed, rounded to 256
    max_seq_len: int = 1024  # encoder side
    max_target_len: int = 1024  # decoder side
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True  # the shared vocab table doubles as the head
    decoder_start_token_id: int = 0  # T5 convention: the pad id starts decoding
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "save_attention"
    # the reference always scans both stacks; kept so its config carries over
    scan_layers: bool = True
    fused_ce_chunks: int = 8
    max_cache_len: Optional[int] = None  # decoder self-attention cache (None -> max_target_len)
    use_fp8: bool = False
    fp8_recipe: str = "current"
    fp8_amax_history_len: int = 16
    pipeline_stages: int = 1
    pipeline_microbatches: Optional[int] = None
    pipeline_schedule: str = "gpipe"

    def __post_init__(self):
        if self.fp8_recipe not in ("current", "delayed"):
            raise ValueError(f"fp8_recipe must be 'current' or 'delayed', got {self.fp8_recipe!r}")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or '1f1b', got {self.pipeline_schedule!r}")
        if self.remat_policy not in ("save_attention", "save_dots", "full"):
            raise ValueError(
                f"remat_policy must be 'save_attention', 'save_dots' or 'full', "
                f"got {self.remat_policy!r}")
        if self.num_decoder_layers is None:
            self.num_decoder_layers = self.num_layers
        if self.max_cache_len is None:
            self.max_cache_len = self.max_target_len
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.head_dim is None:
            self.head_dim = self.embed_dim // self.num_heads
        if self.mlp_dim is None:
            raw = int(self.embed_dim * 8 / 3)
            self.mlp_dim = (raw + 255) // 256 * 256
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads ({self.num_heads}) must be a multiple of "
                             f"num_kv_heads ({self.num_kv_heads})")
        if self.pipeline_stages > 1 and self.num_decoder_layers % self.pipeline_stages != 0:
            raise ValueError(
                f"num_decoder_layers={self.num_decoder_layers} is not divisible by "
                f"pipeline_stages={self.pipeline_stages}")
        if self.fp8_recipe == "delayed" and self.pipeline_stages > 1 \
                and self.pipeline_schedule == "1f1b":
            raise NotImplementedError(DELAYED_1F1B)
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"dtype must be torch.float32, bfloat16 or float16, got {self.dtype}")
        if self.attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(
                f"attention_impl must be 'auto', 'flash' or 'xla', got {self.attention_impl!r}")
        if self.fused_ce_chunks < 1:
            raise ValueError(f"fused_ce_chunks must be >= 1, got {self.fused_ce_chunks}")

    @classmethod
    def tiny(cls, **kw):
        """Test-size model."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("embed_dim", 64)
        kw.setdefault("num_heads", 4)
        kw.setdefault("mlp_dim", 128)
        kw.setdefault("max_seq_len", 64)
        kw.setdefault("max_target_len", 64)
        kw.setdefault("dtype", torch.float32)
        kw.setdefault("remat", False)
        return cls(**kw)

    @property
    def num_params(self) -> int:
        e, h, kv, d, m, v = (self.embed_dim, self.num_heads, self.num_kv_heads,
                             self.head_dim, self.mlp_dim, self.vocab_size)
        self_attn = e * h * d + 2 * e * kv * d + h * d * e
        cross = self_attn
        mlp = 3 * e * m
        enc = self.num_layers * (self_attn + mlp + 2 * e)
        dec = self.num_decoder_layers * (self_attn + cross + mlp + 3 * e)
        head = 0 if self.tie_embeddings else e * v
        return v * e + enc + dec + 2 * e + head


def shift_right(labels: torch.Tensor, start_token_id: int) -> torch.Tensor:
    """T5-style decoder inputs: ``[start, y0, y1, ...]`` (the last label
    dropped); -100 ignore markers become the start id, so every input is
    in the vocabulary."""
    start = torch.full_like(labels[:, :1], start_token_id)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, start, shifted)


class CrossAttention(_Module):
    """Decoder queries over the encoder's keys and values: non-causal, the
    source padding as ``kv_mask``, no RoPE (encoder and decoder positions
    live on different axes). With a cache, ``freeze=True`` (the prefill)
    projects the encoder states and writes K/V and mask into it, and every
    call attends over the cache's frozen K/V."""

    def __init__(self, config: Seq2SeqConfig, device, param_dtype):
        super().__init__()
        e, h, kv, d = config.embed_dim, config.num_heads, config.num_kv_heads, config.head_dim
        self.config = config
        self.wq = self._param((e, h, d), device, param_dtype)
        self.wk = self._param((e, kv, d), device, param_dtype)
        self.wv = self._param((e, kv, d), device, param_dtype)
        self.wo = self._param((h, d, e), device, param_dtype)
        fp8.register_histories(self, fp8.ATTENTION_HISTORIES, config, device)

    def _project(self, x, w, heads, name: str):
        cfg = self.config
        if cfg.use_fp8:
            return fp8.fp8_attn_proj(self, name, x, self._use(w, cfg.dtype), heads,
                                     cfg.head_dim, cfg)
        b, s = x.shape[0], x.shape[1]
        w = self._use(w, cfg.dtype).reshape(cfg.embed_dim, heads * cfg.head_dim)
        return (x @ w).reshape(b, s, heads, cfg.head_dim).transpose(1, 2)

    def forward(self, x, enc=None, enc_mask=None, cache=None, freeze: bool = False):
        cfg = self.config
        q = self._project(x, self.wq, cfg.num_heads, "wq_fp8")
        if cache is None or freeze:
            if enc is None:
                raise ValueError("cross-attention needs the encoder output")
            k = self._project(enc, self.wk, cfg.num_kv_heads, "wk_fp8")
            v = self._project(enc, self.wv, cfg.num_kv_heads, "wv_fp8")
            mask = enc_mask
        if cache is not None:
            if freeze:
                t = enc.shape[1]
                if t > cache["k"].shape[2]:
                    raise ValueError(f"a {t}-token source does not fit the "
                                     f"{cache['k'].shape[2]}-position cross-attention cache")
                for name, value in (("k", k), ("v", v)):
                    cache[name].zero_()
                    cache[name][:, :, :t] = value
                cache["mask"].zero_()
                cache["mask"][:, :t] = 1 if mask is None else mask
            k, v, mask = cache["k"], cache["v"], cache["mask"]
        out = dot_product_attention(q, k, v, causal=False, kv_mask=mask,
                                    impl=cfg.attention_impl)
        if cfg.use_fp8:
            return fp8.fp8_attn_out(self, "wo_fp8", out, self._use(self.wo, cfg.dtype), cfg)
        b, h, s, d = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * d)
        return out @ self._use(self.wo, cfg.dtype).reshape(h * d, cfg.embed_dim)


class _Block(_Module):
    def _norm(self, x, w):
        return rms_norm(x, self._use(w), self.config.norm_eps)

    def _drop(self, y, drop, site: int):
        return y if drop is None else dropout(y, self.config.dropout_rate, drop, site)


class EncoderBlock(_Block):
    """Bidirectional self-attention over the source padding mask, then the
    MLP, each a residual (the reference's ``_EncoderBlock``)."""

    def __init__(self, config: Seq2SeqConfig, device, param_dtype, norm_dtype):
        super().__init__()
        self.config = config
        self.ln_attn = nn.Parameter(torch.ones(config.embed_dim, device=device, dtype=norm_dtype))
        self.ln_mlp = nn.Parameter(torch.ones(config.embed_dim, device=device, dtype=norm_dtype))
        self.attn = DecoderAttention(config, device, param_dtype, causal=False)
        self.mlp = DecoderMLP(config, device, param_dtype)

    def _body(self, x, sin, cos, kv_mask, drop):
        x = x + self._drop(self.attn(self._norm(x, self.ln_attn), sin, cos, kv_mask=kv_mask),
                           drop, 0)
        return x + self._drop(self.mlp(self._norm(x, self.ln_mlp)), drop, 1)

    def forward(self, x, sin, cos, kv_mask=None, drop=None):
        self._stage()
        return self._remat(self._body, x, sin, cos, kv_mask, drop)


class DecoderBlock(_Block):
    """Causal self-attention (cached in generation), cross-attention over
    the encoder, then the MLP, each a residual (the reference's
    ``_DecoderBlock``)."""

    def __init__(self, config: Seq2SeqConfig, device, param_dtype, norm_dtype):
        super().__init__()
        self.config = config
        for name in ("ln_self", "ln_cross", "ln_mlp"):
            setattr(self, name, nn.Parameter(
                torch.ones(config.embed_dim, device=device, dtype=norm_dtype)))
        self.self_attn = DecoderAttention(config, device, param_dtype)
        self.cross_attn = CrossAttention(config, device, param_dtype)
        self.mlp = DecoderMLP(config, device, param_dtype)

    def _body(self, x, enc, sin, cos, enc_mask, drop, cache=None, cache_positions=None):
        y = self.self_attn(self._norm(x, self.ln_self), sin, cos,
                           cache=None if cache is None else cache["self"],
                           cache_positions=cache_positions)
        x = x + self._drop(y, drop, 0)
        y = self.cross_attn(self._norm(x, self.ln_cross), enc, enc_mask,
                            cache=None if cache is None else cache["cross"],
                            freeze=cache is not None and cache_positions is None)
        x = x + self._drop(y, drop, 1)
        return x + self._drop(self.mlp(self._norm(x, self.ln_mlp)), drop, 2)

    def forward(self, x, enc, sin, cos, enc_mask=None, drop=None, cache=None,
                cache_positions=None):
        self._stage()
        if cache is not None:
            return self._body(x, enc, sin, cos, enc_mask, drop, cache, cache_positions)
        return self._remat(self._body, x, enc, sin, cos, enc_mask, drop)


class Seq2SeqLM(_Model):
    """T5-family seq2seq LM.

    Training: ``forward(input_ids, decoder_input_ids=None, labels=...,
    attention_mask=None)`` -> ``{"loss"}`` (the fused chunked LM-head CE;
    logits are never materialized), or ``{"logits"}`` [B, S, V] fp32
    without labels. Inference: :meth:`encode`, then :meth:`decode`'s
    prefill and decode steps over :meth:`init_cache` (used by
    ``generation.generate_seq2seq``).

    ``device=None`` means CUDA and raises without it; pass
    ``device="cpu"`` for the plain versions on the CPU. ``param_dtype``
    None stores matmul weights and the embedding in the compute dtype and
    norms in fp32, frozen (serving); a dtype stores every parameter in it,
    trainable (fp32 master weights for training). ``mesh`` (a
    ``DeviceMesh``) makes the loss the mean over the global batch; on a
    ``sequence`` axis each rank's chunks of the inputs and labels are
    gathered into the whole sequences first, which every rank of the axis
    then runs (the reference's attention there is not a ring).
    Parameters are created uninitialized: load them with
    ``models/convert.py``."""

    pipeline_stack = "decoder"

    def __init__(self, config: Seq2SeqConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None, mesh=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        dt = param_dtype or config.dtype
        norm_dt = param_dtype or torch.float32
        e = config.embed_dim
        self.embedding = self._param((config.vocab_size, e), self.device, dt)
        self.lm_head = None
        if not config.tie_embeddings:
            self.lm_head = self._param((e, config.vocab_size), self.device, dt)
        self.ln_enc = nn.Parameter(torch.ones(e, device=self.device, dtype=norm_dt))
        self.ln_dec = nn.Parameter(torch.ones(e, device=self.device, dtype=norm_dt))
        self.encoder = nn.ModuleList(EncoderBlock(config, self.device, dt, norm_dt)
                                     for _ in range(config.num_layers))
        self.mesh = mesh
        held = self.held_layers()
        self.decoder = nn.ModuleList(
            DecoderBlock(config, self.device, dt, norm_dt) if i in held else _Absent()
            for i in range(config.num_decoder_layers))
        if param_dtype is None:
            self.requires_grad_(False)
        self.set_mesh(mesh)

    def init_cache(self, batch: int, length: Optional[int] = None) -> list:
        """All-zeros decode cache for ``batch`` rows: per decoder layer the
        self-attention's ``{"k", "v"}`` [B, KVH, length, D] (``length``
        None: ``config.max_cache_len``) and ``"index"`` 0, and the
        cross-attention's ``{"k", "v"}`` [B, KVH, max_seq_len, D] with
        ``"mask"`` [B, max_seq_len] int32, all in the compute dtype."""
        cfg = self.config
        length = int(length or cfg.max_cache_len)

        def zeros(*shape, dtype=cfg.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        kv, d = cfg.num_kv_heads, cfg.head_dim
        return [{"self": {"k": zeros(batch, kv, length, d), "v": zeros(batch, kv, length, d),
                          "index": 0},
                 "cross": {"k": zeros(batch, kv, cfg.max_seq_len, d),
                           "v": zeros(batch, kv, cfg.max_seq_len, d),
                           "mask": zeros(batch, cfg.max_seq_len, dtype=torch.int32)}}
                for _ in range(cfg.num_decoder_layers)]

    def _tables(self, positions):
        cfg = self.config
        return rotary_embedding_tables(positions, cfg.head_dim, theta=cfg.rope_theta,
                                       dtype=cfg.dtype)

    def _encode(self, input_ids, attention_mask, drop):
        cfg = self.config
        x = self._gather(self.embedding, input_ids, cfg.dtype)
        sin, cos = self._tables(torch.arange(input_ids.shape[1], device=input_ids.device))
        for i, block in enumerate(self.encoder):
            x = block(x, sin, cos, attention_mask, drop=None if drop is None else (*drop, i))
        return rms_norm(x, self._use(self.ln_enc), cfg.norm_eps)

    def _decoder_hidden(self, ids, enc, enc_mask, positions=None, drop=None, cache=None,
                        cache_positions=None):
        cfg = self.config
        x = self._gather(self.embedding, ids, cfg.dtype)
        if positions is None:
            positions = torch.arange(ids.shape[1], device=ids.device)
        sin, cos = self._tables(positions)
        for i, block in enumerate(self.decoder):
            x = block(x, enc, sin, cos, enc_mask,
                      drop=None if drop is None else (*drop, cfg.num_layers + i),
                      cache=None if cache is None else cache[i],
                      cache_positions=cache_positions)
        return rms_norm(x, self._use(self.ln_dec), cfg.norm_eps)

    def _head(self):
        cfg = self.config
        if cfg.tie_embeddings:
            return self._use(_resolve(self.embedding), cfg.dtype).t()
        return self._use(self.lm_head, cfg.dtype)

    def encode(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        """[B, T] source tokens (and their [B, T] padding mask) -> [B, T, E]
        encoder states."""
        self._stage()
        self._arm_casts()
        self._arm_fp8(cache_free=False)  # an inference call, as the reference's generation
        return self._encode(input_ids, attention_mask, None)

    def decode(self, decoder_input_ids: torch.Tensor, encoder_states=None, attention_mask=None,
               positions=None, *, cache=None, cache_positions=None) -> torch.Tensor:
        """[B, S] target tokens -> [B, S, V] fp32 logits. Without ``cache``:
        the uncached forward over ``encoder_states`` (and the source mask).
        With ``cache`` and no ``cache_positions``: the prefill, which writes
        the self-attention cache at [0, S) and freezes the cross-attention
        K/V and mask of ``encoder_states``. With ``cache_positions`` [B]
        (int64): one decode step, each row's token written at its position
        and attending its prefix (``positions`` [B, 1], the same values, set
        the RoPE), the cross-attention over the frozen K/V."""
        if cache_positions is not None and cache is None:
            raise ValueError("cache_positions needs a cache")
        if cache_positions is None and encoder_states is None:
            raise ValueError("decode needs the encoder states (a prefill or an uncached call)")
        if self.num_stages > 1:
            if cache is not None:
                raise NotImplementedError(
                    "KV-cache decode through the pipeline stages is not supported (a decode "
                    "step is serial across stages by construction); fold the stages back "
                    "with generation.depipeline() and generate from that model")
            self._arm_casts(cache_free=True)
            self._arm_fp8(cache_free=False)
            return self._pipelined(decoder_input_ids, lambda: encoder_states, attention_mask,
                                   None, None)["logits"]
        self._stage()
        self._arm_casts(cache_free=cache is None)
        self._arm_fp8(cache_free=False)
        x = self._decoder_hidden(decoder_input_ids, encoder_states, attention_mask, positions,
                                 cache=cache, cache_positions=cache_positions)
        return (x @ self._head()).float()

    def forward(self, input_ids: torch.Tensor, decoder_input_ids: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None, _piece=None):
        if _piece is not None:  # a piece of the 1F1B schedule (DecoderLM.forward's)
            return _piece()
        cfg = self.config
        if axis_size(self.mesh, "sequence") > 1:
            input_ids, decoder_input_ids, labels, attention_mask = (
                None if t is None else gather_sequence(t, self.mesh)
                for t in (input_ids, decoder_input_ids, labels, attention_mask))
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("need decoder_input_ids and/or labels")
            decoder_input_ids = shift_right(labels, cfg.decoder_start_token_id)
        self._stage()
        self._arm_casts()
        self._arm_fp8()
        drop = None
        if cfg.dropout_rate > 0.0 and self.training:
            drop = next_key("dropout")
        if self.num_stages > 1:
            return self._pipelined(decoder_input_ids,
                                   lambda: self._encode(input_ids, attention_mask, drop),
                                   attention_mask, labels, drop)
        enc = self._encode(input_ids, attention_mask, drop)
        x = self._decoder_hidden(decoder_input_ids, enc, attention_mask, drop=drop)
        if labels is None:
            return {"logits": (x @ self._head()).float()}
        b, s = x.shape[0], x.shape[1]
        total, count = fused_linear_cross_entropy_parts(
            x.reshape(b * s, cfg.embed_dim), self._head(), labels.reshape(b * s),
            ignore_index=-100, num_chunks=cfg.fused_ce_chunks)
        return {"loss": mesh_mean(total, count, self.mesh)}

    # -- pipeline parallelism over the decoder tower (parallel/pipeline.py)

    def _stage_fn(self, s_dec: int, sin, cos, drop, masks):
        """``(s, m, belt) -> (belt, 0.0)``: stage s's decoder blocks on
        microbatch m's belt [mb, S + T, E], the decoder states in front and
        the encoder output behind. The encoder output passes through, so it
        travels the belt beside the states and its cotangent sums every
        stage's cross-attention. Dropout is keyed by (layer, microbatch),
        the delayed fp8 histories viewed per microbatch (as
        ``DecoderLM._stage_fn``); ``masks`` are the per-microbatch source
        masks (None: no mask)."""
        cfg = self.config
        n_enc, n_all = cfg.num_layers, cfg.num_layers + cfg.num_decoder_layers
        view = self.fp8_forward

        def run(st, m, buf):
            blocks = self.stage_blocks(st)
            if view is not None:
                for _, block in blocks:
                    _set_fp8_view(block, fp8.Fp8Forward(view.record))
            x, mem = buf[:, :s_dec], buf[:, s_dec:]
            mask = None if masks is None else masks[m]
            for i, block in blocks:
                x = block(x, mem, sin, cos, mask,
                          drop=None if drop is None else (*drop, n_enc + i + n_all * m))
            return torch.cat([x, mem], dim=1), 0.0

        return run

    def _belt(self, dec_ids, encode, M: int):
        """Stage 0's input: [M, mb, S + T, E], the decoder embeddings beside
        the encoder output, strided microbatches."""
        from ..parallel.pipeline import split_microbatches

        x = self._gather(self.embedding, dec_ids, self.config.dtype)
        return split_microbatches(torch.cat([x, encode()], dim=1), M)

    def _pipelined(self, dec_ids, encode, attention_mask, labels, drop):
        """The decoder tower under GPipe (``parallel/pipeline.gpipe``):
        ``{"logits"}`` on every rank of the stage group, or ``{"loss"}``
        the same on every rank. ``encode()`` gives the encoder states
        where stage 0 runs."""
        from ..parallel.pipeline import (Handoff, adapt_microbatches, gpipe,
                                         merge_microbatches, split_microbatches)

        cfg = self.config
        _refuse_delayed_1f1b(cfg)
        plan = self.stage_plan()
        S = plan.num_stages
        b, s_dec = dec_ids.shape
        M = adapt_microbatches(b, cfg.pipeline_microbatches or S, S)
        masks = None if attention_mask is None else \
            list(split_microbatches(attention_mask, M).unbind(0))
        inputs = list(self._belt(dec_ids, encode, M).unbind(0)) if plan.first else None
        t_enc = inputs[0].shape[1] - s_dec if plan.first else None
        t_enc = _from_first_stage(t_enc, plan)
        sin, cos = self._tables(torch.arange(s_dec, device=dec_ids.device))
        handoff = Handoff(plan, (b // M, s_dec + t_enc, cfg.embed_dim), cfg.dtype, dec_ids.device)
        outs, _, tail = gpipe(self._stage_fn(s_dec, sin, cos, drop, masks), inputs, M, plan,
                              handoff)
        x = None
        if plan.last:
            x = rms_norm(merge_microbatches(outs)[:, :s_dec], self._use(self.ln_dec), cfg.norm_eps)
        if labels is None:
            logits = (x @ self._head()).float() if plan.last else None
            return {"logits": _from_last_stage(logits, (b, s_dec, cfg.vocab_size), plan,
                                               dec_ids.device)}
        if plan.last:
            total, count = fused_linear_cross_entropy_parts(
                x.reshape(b * s_dec, cfg.embed_dim), self._head(), labels.reshape(b * s_dec),
                ignore_index=-100, num_chunks=cfg.fused_ce_chunks)
        else:
            total = count = torch.zeros((), device=dec_ids.device)
        return {"loss": tail(pipeline_mean(total, count, self.mesh))}

    def pipeline_value_and_grad(self):
        """The 1F1B value-and-grad of the decoder tower (``config.
        pipeline_schedule == "1f1b"`` over more than one stage; None
        otherwise): ``vag(input_ids, labels, scale=None,
        attention_mask=None) -> {"loss"}``, as ``DecoderLM``'s. The encoder
        runs once under autograd where stage 0 runs (its output is one
        [B, T, E] tensor, O(1) in microbatches); the memory part of the
        belt's input cotangent feeds its backward. Labels align 1:1 with
        the decoder positions (no shift)."""
        if self.config.pipeline_schedule != "1f1b" or self.num_stages <= 1:
            return None
        _refuse_delayed_1f1b(self.config)
        return self._one_f_one_b

    def _one_f_one_b(self, input_ids, labels, scale=None, attention_mask=None):
        from ..parallel.pipeline import adapt_microbatches, split_microbatches

        cfg = self.config
        b, s_dec = labels.shape
        t_enc = input_ids.shape[1]
        S = self.num_stages
        M = adapt_microbatches(b, cfg.pipeline_microbatches or S, S)
        dec_ids = shift_right(labels, cfg.decoder_start_token_id)
        self.release_casts()  # each piece casts at use (run_one_f_one_b)
        self._arm_fp8()
        drop = None
        if cfg.dropout_rate > 0.0 and self.training:
            drop = next_key("dropout")
        sin, cos = self._tables(torch.arange(s_dec, device=labels.device))
        labels_mb = split_microbatches(labels, M)
        masks = None if attention_mask is None else \
            list(split_microbatches(attention_mask, M).unbind(0))

        def head_total(m, y):
            h = rms_norm(y[:, :s_dec], self._use(self.ln_dec), cfg.norm_eps)
            total, _ = fused_linear_cross_entropy_parts(
                h.reshape(-1, cfg.embed_dim), self._head(), labels_mb[m].reshape(-1),
                ignore_index=-100, num_chunks=cfg.fused_ce_chunks)
            return total

        return run_one_f_one_b(
            self, M, (b // M, s_dec + t_enc, cfg.embed_dim),
            lambda: self._belt(dec_ids, lambda: self._encode(input_ids, attention_mask, drop), M),
            self._stage_fn(s_dec, sin, cos, drop, masks), head_total,
            (labels_mb != -100).sum(), scale)


def _from_first_stage(value, plan):
    """An int only stage 0's owner knows, on every rank of the stage
    group."""
    if plan.group is None:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, group=plan.group, group_src=plan.owner(0))
    return box[0]
