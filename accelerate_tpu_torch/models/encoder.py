"""BERT-family encoder and sequence-classification head.

Counterpart of ``accelerate_tpu/models/encoder.py``: word, position and
token-type embeddings with a LayerNorm, post-norm blocks (bidirectional
attention over the padding mask, then a tanh-GELU MLP, each a residual
followed by a LayerNorm), the tanh pooler on the first (CLS) token and the
classifier, whose logits feed ``softmax_cross_entropy`` when labels are
given. Parameters keep the reference's names and layouts: the top-level
``word_embedding`` ... ``classifier_bias``, and the unscanned blocks'
``layer_{i}/wq`` ... ``layer_{i}/b_out`` as ``layers.{i}.wq`` ...
(``models/convert.py``).

Attention at BERT's head_dim 64 is the plain ``mha_reference`` with the
padding folded into its bias (``ops/attention.dot_product_attention``):
the reference takes its flash kernel only where head_dim is a multiple of
128, and so does the port, so no kernel runs on this model's path.

With ``config.use_fp8`` the QKV / O projections and ``w_in`` / ``w_out``
run the fp8 recipe (``ops/fp8.py``), the delayed recipe's histories under
the reference's names (``wq_fp8`` ... ``wo_fp8``, ``mlp_in``,
``mlp_out``).

The reference's ``_embed_gather`` is a custom VJP for sharded meshes whose
gradient is the one-hot contraction, the same sum as the gather's own
backward, so the port gathers with plain indexing. Residual dropout
(``config.dropout_rate``) follows the embedding LayerNorm, each block's
attention and MLP, and the pooler, in training mode, with masks from the
keychain's ``"dropout"`` stream (``models/decoder.dropout``): the blocks
at layers 0..N-1, the embedding (site 0) and the pooler (site 1) at layer
N. ``config.remat`` checkpoints each whole block, as the reference's
``nn.remat`` without a policy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fp8
from ..ops.attention import dot_product_attention
from ..ops.losses import mesh_mean, softmax_cross_entropy
from ..parallel.context import gather_sequence
from ..parallel.mesh import axis_size
from ..utils.random import next_key
from .configs import EncoderConfig
from .decoder import _Model, _Module, dropout, resolve_device


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm with fp32 internal math, output in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class EncoderBlock(_Module):
    def __init__(self, config: EncoderConfig, device, param_dtype, norm_dtype):
        super().__init__()
        e, h, m = config.embed_dim, config.num_heads, config.mlp_dim
        d = config.head_dim
        self.config = config
        for name, shape in (("wq", (e, h, d)), ("wk", (e, h, d)), ("wv", (e, h, d)),
                            ("wo", (h, d, e))):
            setattr(self, name, self._param(shape, device, param_dtype))
        for i in (1, 2):
            setattr(self, f"ln{i}_scale",
                    nn.Parameter(torch.ones(e, device=device, dtype=norm_dtype)))
            setattr(self, f"ln{i}_bias",
                    nn.Parameter(torch.zeros(e, device=device, dtype=norm_dtype)))
        self.w_in = self._param((e, m), device, param_dtype)
        self.b_in = nn.Parameter(torch.zeros(m, device=device, dtype=param_dtype))
        self.w_out = self._param((m, e), device, param_dtype)
        self.b_out = nn.Parameter(torch.zeros(e, device=device, dtype=param_dtype))
        fp8.register_histories(self, fp8.ATTENTION_HISTORIES + fp8.ENCODER_MLP_HISTORIES,
                               config, device)

    def _body(self, x, kv_mask, drop):
        cfg = self.config
        dt, e, h, d = cfg.dtype, cfg.embed_dim, cfg.num_heads, cfg.head_dim
        b, s = x.shape[0], x.shape[1]

        def heads(w, name):
            if cfg.use_fp8:
                return fp8.fp8_attn_proj(self, name, x, self._use(w, dt), h, d, cfg)
            return (x @ self._use(w, dt).reshape(e, h * d)).reshape(b, s, h, d).transpose(1, 2)

        attn = dot_product_attention(heads(self.wq, "wq_fp8"), heads(self.wk, "wk_fp8"),
                                     heads(self.wv, "wv_fp8"), causal=False, kv_mask=kv_mask)
        if cfg.use_fp8:
            attn = fp8.fp8_attn_out(self, "wo_fp8", attn, self._use(self.wo, dt), cfg)
        else:
            attn = (attn.transpose(1, 2).reshape(b, s, h * d)
                    @ self._use(self.wo, dt).reshape(h * d, e))
        if drop is not None:
            attn = dropout(attn, cfg.dropout_rate, drop, 0)
        x = _layer_norm(x + attn, self._use(self.ln1_scale), self._use(self.ln1_bias),
                        cfg.norm_eps)
        # module_fp8_dot is the plain product without use_fp8
        hidden = F.gelu(fp8.module_fp8_dot(self, "mlp_in", x, self._use(self.w_in, dt), cfg)
                        + self._use(self.b_in, dt), approximate="tanh")
        out = (fp8.module_fp8_dot(self, "mlp_out", hidden, self._use(self.w_out, dt), cfg)
               + self._use(self.b_out, dt))
        if drop is not None:
            out = dropout(out, cfg.dropout_rate, drop, 1)
        return _layer_norm(x + out, self._use(self.ln2_scale), self._use(self.ln2_bias),
                           cfg.norm_eps)

    def forward(self, x, kv_mask=None, drop=None):
        self._stage()
        return self._remat(self._body, x, kv_mask, drop)


def _stage_axis(mesh) -> int:
    shape = getattr(mesh, "shape", mesh)
    return int(shape.get("stage", 1)) if hasattr(shape, "get") else 1


class EncoderClassifier(_Model):
    """``forward(input_ids, attention_mask=None, token_type_ids=None,
    labels=None) -> {"logits"[, "loss"]}``: HF
    AutoModelForSequenceClassification's shape.

    ``device=None`` means CUDA and raises without it (``device="cpu"`` for
    the CPU). ``param_dtype`` None stores matmul weights, biases and
    embeddings in the compute dtype and LayerNorms in fp32, frozen; a dtype
    stores every parameter in it, trainable (fp32 masters for training).
    ``mesh`` (a ``DeviceMesh``) makes the loss the mean over the global
    batch; on a ``sequence`` axis each rank's chunks are gathered into the
    whole sequence first, which every rank of the axis then attends over
    (the reference's attention there is bidirectional, not a ring); one
    with a "stage" axis raises with the reference's message. Parameters
    are created uninitialized: load them with ``models/convert.py``."""

    def __init__(self, config: EncoderConfig, device=None,
                 param_dtype: Optional[torch.dtype] = None, mesh=None):
        super().__init__()
        if mesh is not None and _stage_axis(mesh) > 1:
            raise NotImplementedError(
                "EncoderClassifier does not support pipeline parallelism: the mesh has a "
                f"'stage' axis of size {_stage_axis(mesh)} but encoder-only models have no "
                "stage split. Use DecoderLM or Seq2SeqLM for pipeline stages, or drop "
                "pipeline_parallel from the sharding config for BERT-family models.")
        self.config = config
        self.device = resolve_device(device)
        dt = param_dtype or config.dtype
        norm_dt = param_dtype or torch.float32
        e, dev = config.embed_dim, self.device
        self.word_embedding = self._param((config.vocab_size, e), dev, dt)
        self.position_embedding = self._param((config.max_seq_len, e), dev, dt)
        self.type_embedding = self._param((config.type_vocab_size, e), dev, dt)
        self.ln_embed_scale = nn.Parameter(torch.ones(e, device=dev, dtype=norm_dt))
        self.ln_embed_bias = nn.Parameter(torch.zeros(e, device=dev, dtype=norm_dt))
        self.pooler_kernel = self._param((e, e), dev, dt)
        self.pooler_bias = nn.Parameter(torch.zeros(e, device=dev, dtype=dt))
        self.classifier_kernel = self._param((e, config.num_labels), dev, dt)
        self.classifier_bias = nn.Parameter(torch.zeros(config.num_labels, device=dev, dtype=dt))
        self.layers = nn.ModuleList(EncoderBlock(config, dev, dt, norm_dt)
                                    for _ in range(config.num_layers))
        if param_dtype is None:
            self.requires_grad_(False)
        self.set_mesh(mesh)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None):
        cfg = self.config
        if axis_size(self.mesh, "sequence") > 1:
            input_ids, attention_mask, token_type_ids = (
                None if t is None else gather_sequence(t, self.mesh)
                for t in (input_ids, attention_mask, token_type_ids))
        s = input_ids.shape[1]
        self._stage()
        self._arm_casts()
        self._arm_fp8()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # summed in the parameters' dtype at use, then cast, as the reference
        x = (self._gather(self.word_embedding, input_ids)
             + self._use(self.position_embedding)[None, :s]
             + self._gather(self.type_embedding, token_type_ids))
        x = _layer_norm(x.to(cfg.dtype), self._use(self.ln_embed_scale),
                        self._use(self.ln_embed_bias), cfg.norm_eps)
        drop = None
        if cfg.dropout_rate > 0.0 and self.training:
            drop = next_key("dropout")
            x = dropout(x, cfg.dropout_rate, (*drop, cfg.num_layers), 0)
        kv_mask = None if attention_mask is None else attention_mask.to(torch.int32)
        for i, block in enumerate(self.layers):
            x = block(x, kv_mask, drop=None if drop is None else (*drop, i))
        dt = cfg.dtype
        pooled = torch.tanh(x[:, 0] @ self._use(self.pooler_kernel, dt)
                            + self._use(self.pooler_bias, dt))
        if drop is not None:
            pooled = dropout(pooled, cfg.dropout_rate, (*drop, cfg.num_layers), 1)
        logits = (pooled @ self._use(self.classifier_kernel, dt)
                  + self._use(self.classifier_bias, dt)).float()
        out = {"logits": logits}
        if labels is not None:
            if self.mesh is None:
                out["loss"] = softmax_cross_entropy(logits, labels)
            else:
                nll = torch.logsumexp(logits, dim=-1) - logits.gather(
                    -1, labels.long()[:, None])[:, 0]
                out["loss"] = mesh_mean(nll.sum(), torch.tensor(
                    float(nll.numel()), device=nll.device), self.mesh)
        return out
