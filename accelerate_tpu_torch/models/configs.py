"""Decoder, encoder and vision configurations and size presets.

Counterpart of ``accelerate_tpu/models/configs.py``: the same field names
and defaults for everything serving, generation, big-model dispatch and
the training step read, with torch dtypes. ``kv_cache_dtype`` takes
"bf16", "int8" and "int4" on every cache (the dense cache, the flat and
the paged arena). Weight streaming needs no flag: big-model dispatch
(``big_modeling.py``) streams every weight it places in host memory or
on disk, so ``stream_layer_weights`` is accepted only as False, for a
reference config to carry over. ``dtype`` takes float32, bfloat16 and
float16 (fp16 training runs the flash kernels' fp16 entries). Residual
dropout (``dropout_rate``), the three remat policies and MoE blocks
(``moe_num_experts`` >= 2, ``models/moe.py``) and the fp8 projections
(``use_fp8``, ``fp8_recipe``, ``fp8_amax_history_len``; ``ops/fp8.py``)
and pipelining (``pipeline_stages``, ``pipeline_microbatches``,
``pipeline_schedule``; ``parallel/pipeline.py``) are ported. The
reference's ``decode_kernel`` /
``decode_kernel_block`` knobs are not carried: the Hopper decode kernels
walk 64-token chunks, so there is no kv block to choose.

:class:`EncoderConfig` is the BERT family's (``models/encoder.py``),
:class:`VisionConfig` the ResNet family's (``models/vision.py``); the
T5 family's ``Seq2SeqConfig`` lives beside its model in
``models/seq2seq.py``, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


# the reference's refusal (its models/decoder.py:689-706), kept: the 1F1B
# value-and-grad runs current scaling only
DELAYED_1F1B = (
    "delayed fp8 scaling + the 1f1b schedule is not wired (the manual backward "
    "cannot thread the amax-history collection); use pipeline_schedule='gpipe' or "
    "fp8_recipe='current'")


@dataclass
class DecoderConfig:
    """LLaMA-family causal LM config (GQA, SwiGLU, RMSNorm, split-half RoPE)."""

    vocab_size: int = 32_000
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # None -> MHA
    head_dim: Optional[int] = None  # None -> embed_dim // num_heads
    mlp_dim: Optional[int] = None  # None -> ~8/3 * embed, rounded to 256
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16  # compute dtype for activations
    # cache-free attention (ops/attention.dot_product_attention): "flash"
    # runs the flash kernels (their plain versions on the CPU), "xla" the
    # plain attention, "auto" the kernels on CUDA where the shapes allow
    attention_impl: str = "auto"
    # training: per-block activation checkpointing (models/decoder.py).
    # "full" recomputes the whole block in backward; "save_attention" keeps
    # only the flash op's out and lse; "save_dots" keeps every projection
    # matmul's output and re-runs the flash forward
    remat: bool = True
    remat_policy: str = "save_attention"
    # the reference rolls the blocks into one lax.scan; eager PyTorch runs
    # the same blocks in a loop, so this changes nothing numerically. Kept
    # so a reference config carries over (it decides the reference tree's
    # layout, see models/convert.py)
    scan_layers: bool = True
    # token chunks of the fused LM-head cross entropy (ops/losses.py)
    fused_ce_chunks: int = 8
    # KV-cache length for generation (None -> max_seq_len)
    max_cache_len: Optional[int] = None
    # KV-cache storage precision: "bf16" (the compute dtype), or "int8" /
    # "int4" payloads with one fp32 scale per (token, kv head). The paged
    # arena's geometry (page size, page count) belongs to the serving
    # engine that owns the arena
    kv_cache_dtype: str = "bf16"
    # token-block granule the packed ragged prefill pads each tail to
    prefill_kernel_block: Optional[int] = None
    # the reference's switch for per-layer weight streaming; the port's
    # dispatch streams whatever it places off the card, so True is
    # rejected in __post_init__
    stream_layer_weights: bool = False
    # fp8 recipe (ops/fp8.py): every projection (QKV/O and the MLP) runs
    # e4m3 forward / e5m2 backward. Turned on by Accelerator(
    # mixed_precision="fp8"). ``fp8_recipe``: "current" (each operand's
    # amax every call) or "delayed" (scales from an amax history of
    # ``fp8_amax_history_len`` steps, per-layer buffers of the model)
    use_fp8: bool = False
    fp8_recipe: str = "current"
    fp8_amax_history_len: int = 16
    # mixture-of-experts FFN (models/moe.py): 0 is the dense MLP; top-k
    # routing per batch row with capacity k * factor * tokens / experts
    # and the Switch load-balancing loss, weighted into the training loss
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    # residual dropout after the attention and after the MLP, in training
    # mode only (models/decoder.py)
    dropout_rate: float = 0.0
    # pipeline parallelism (parallel/pipeline.py): the blocks run over
    # ``pipeline_stages`` stages (> 1 here, or the mesh's ``stage`` axis)
    # in ``pipeline_microbatches`` strided microbatches (None: the stage
    # count). ``pipeline_schedule``: "gpipe" (autograd through the forward
    # belt, O(M) activations per stage) or "1f1b" (the hand-scheduled
    # value-and-grad, DecoderLM.pipeline_value_and_grad: O(S) whatever M)
    pipeline_stages: int = 1
    pipeline_microbatches: Optional[int] = None
    pipeline_schedule: str = "gpipe"

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.head_dim is None:
            self.head_dim = self.embed_dim // self.num_heads
        if self.mlp_dim is None:
            raw = int(self.embed_dim * 8 / 3)
            self.mlp_dim = (raw + 255) // 256 * 256
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"num_kv_heads ({self.num_kv_heads})"
            )
        if self.kv_cache_dtype not in ("bf16", "int8", "int4"):
            raise ValueError(
                f"kv_cache_dtype must be 'bf16', 'int8' or 'int4', got "
                f"{self.kv_cache_dtype!r}"
            )
        if self.kv_cache_dtype == "int4" and self.head_dim % 2:
            raise ValueError(
                f"int4 KV packing pairs head_dim values into bytes; head_dim "
                f"must be even, got {self.head_dim}"
            )
        if self.fp8_recipe not in ("current", "delayed"):
            raise ValueError(
                f"fp8_recipe must be 'current' or 'delayed', got {self.fp8_recipe!r}"
            )
        if self.moe_num_experts == 1:
            raise ValueError("moe_num_experts must be 0 (dense) or >= 2")
        if self.moe_num_experts > 1 and not (1 <= self.moe_top_k <= self.moe_num_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, moe_num_experts="
                f"{self.moe_num_experts}]"
            )
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(
                f"dtype must be torch.float32, bfloat16 or float16, got {self.dtype}"
            )
        if self.stream_layer_weights:
            raise ValueError(
                "stream_layer_weights: the port streams host-tier weights whenever "
                "big-model dispatch places them in host memory or on disk "
                "(big_modeling.load_checkpoint_and_dispatch / dispatch_model); "
                "there is no flag to set"
            )
        if self.pipeline_stages > 1 and self.num_layers % self.pipeline_stages != 0:
            raise ValueError(
                f"pipeline_stages={self.pipeline_stages} must divide "
                f"num_layers={self.num_layers} evenly"
            )
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or '1f1b', got {self.pipeline_schedule!r}"
            )
        if self.fp8_recipe == "delayed" and self.pipeline_stages > 1 \
                and self.pipeline_schedule == "1f1b":
            raise NotImplementedError(DELAYED_1F1B)
        if self.remat_policy not in ("full", "save_attention", "save_dots"):
            raise ValueError(
                f"remat_policy must be 'full', 'save_attention' or 'save_dots', "
                f"got {self.remat_policy!r}"
            )
        if self.fused_ce_chunks < 1:
            raise ValueError(f"fused_ce_chunks must be >= 1, got {self.fused_ce_chunks}")
        if self.attention_impl not in ("xla", "flash", "auto"):
            raise ValueError(
                f"attention_impl must be 'auto', 'flash' or 'xla', got "
                f"{self.attention_impl!r}"
            )
        if self.prefill_kernel_block is not None and self.prefill_kernel_block < 1:
            raise ValueError(
                f"prefill_kernel_block must be a positive token-block size, "
                f"got {self.prefill_kernel_block}"
            )

    @property
    def num_params(self) -> int:
        e, h, kv, d, m, v = (
            self.embed_dim, self.num_heads, self.num_kv_heads,
            self.head_dim, self.mlp_dim, self.vocab_size,
        )
        if self.moe_num_experts > 1:
            # per-expert gate / up / down banks and the router
            mlp = self.moe_num_experts * 3 * e * m + e * self.moe_num_experts
        else:
            mlp = 3 * e * m
        per_layer = e * h * d + 2 * e * kv * d + h * d * e + mlp + 2 * e
        head = 0 if self.tie_embeddings else e * v
        return self.num_layers * per_layer + v * e + head + e

    @classmethod
    def tiny(cls, **kw):
        """Test-size model."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("embed_dim", 64)
        kw.setdefault("num_heads", 4)
        kw.setdefault("mlp_dim", 128)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("dtype", torch.float32)
        kw.setdefault("remat", False)
        return cls(**kw)

    @classmethod
    def small_1b(cls, **kw):
        """0.821B model (``num_params``): 16 layers, E 2048, 16 heads over 8
        kv heads, M 5632. The reference's docstring says ~1.2B."""
        kw.setdefault("vocab_size", 32_000)
        kw.setdefault("num_layers", 16)
        kw.setdefault("embed_dim", 2048)
        kw.setdefault("num_heads", 16)
        kw.setdefault("num_kv_heads", 8)
        kw.setdefault("max_seq_len", 2048)
        return cls(**kw)

    @classmethod
    def llama_7b(cls, **kw):
        """6.7B model: 32 layers, E 4096, 32 heads (MHA), D 128, M 11008,
        untied LM head."""
        kw.setdefault("vocab_size", 32_000)
        kw.setdefault("num_layers", 32)
        kw.setdefault("embed_dim", 4096)
        kw.setdefault("num_heads", 32)
        kw.setdefault("mlp_dim", 11_008)
        kw.setdefault("max_seq_len", 4096)
        kw.setdefault("tie_embeddings", False)
        return cls(**kw)


@dataclass
class EncoderConfig:
    """BERT-family encoder config (the reference's, with torch dtypes):
    the fp8 knobs are the decoder's."""

    vocab_size: int = 30_522
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    dropout_rate: float = 0.1
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    # per-block activation checkpointing of the whole block ("full")
    remat: bool = False
    use_fp8: bool = False
    fp8_recipe: str = "current"
    fp8_amax_history_len: int = 16

    def __post_init__(self):
        if self.fp8_recipe not in ("current", "delayed"):
            raise ValueError(f"fp8_recipe must be 'current' or 'delayed', got {self.fp8_recipe!r}")
        if self.embed_dim % self.num_heads:
            raise ValueError(f"embed_dim ({self.embed_dim}) must be a multiple of "
                             f"num_heads ({self.num_heads})")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"dtype must be torch.float32, bfloat16 or float16, got {self.dtype}")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        """Test-size model."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("num_layers", 2)
        kw.setdefault("embed_dim", 64)
        kw.setdefault("num_heads", 4)
        kw.setdefault("mlp_dim", 128)
        kw.setdefault("max_seq_len", 64)
        kw.setdefault("dtype", torch.float32)
        return cls(**kw)

    @classmethod
    def bert_base(cls, **kw):
        """The defaults: 12 layers, E 768, 12 heads (D 64), M 3072."""
        return cls(**kw)


@dataclass
class VisionConfig:
    """ResNet-family config (the reference's, with torch dtypes): NHWC
    images, ``dtype`` activations with fp32 BatchNorm statistics.
    ``bn_momentum`` is flax's (the running average keeps ``momentum`` of
    itself), not torch's."""

    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    num_filters: int = 64
    num_classes: int = 1000
    block: str = "bottleneck"  # "bottleneck" (50/101/152) or "basic" (18/34)
    image_size: int = 224
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    stem: str = "imagenet"  # "imagenet" = 7x7/2 + maxpool; "cifar" = 3x3/1

    def __post_init__(self):
        if self.block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', got {self.block!r}")
        if self.stem not in ("imagenet", "cifar"):
            raise ValueError(f"stem must be 'imagenet' or 'cifar', got {self.stem!r}")
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"dtype must be torch.float32, bfloat16 or float16, got {self.dtype}")

    @classmethod
    def tiny(cls, **kw):
        """Test-size model."""
        kw.setdefault("stage_sizes", (1, 1))
        kw.setdefault("num_filters", 8)
        kw.setdefault("num_classes", 10)
        kw.setdefault("block", "basic")
        kw.setdefault("image_size", 32)
        kw.setdefault("stem", "cifar")
        kw.setdefault("dtype", torch.float32)
        return cls(**kw)

    @classmethod
    def resnet18(cls, **kw):
        kw.setdefault("stage_sizes", (2, 2, 2, 2))
        kw.setdefault("block", "basic")
        return cls(**kw)

    @classmethod
    def resnet50(cls, **kw):
        return cls(**kw)

    @classmethod
    def resnet101(cls, **kw):
        kw.setdefault("stage_sizes", (3, 4, 23, 3))
        return cls(**kw)
