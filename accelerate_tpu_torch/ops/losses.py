"""Cross-entropy losses.

Counterpart of ``accelerate_tpu/ops/losses.py``. The LM head's fp32
logits [B*S, V] are the largest activation of decoder training;
:func:`fused_linear_cross_entropy` never keeps them: the hidden states are
cut into token chunks, each chunk's ``hidden @ W_vocab`` and
softmax-CE run inside ``torch.utils.checkpoint`` (as the reference runs
them inside ``jax.checkpoint``), so the backward recomputes each chunk's
logits instead of storing them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore_index: Optional[int]):
    """fp32 logsumexp and the per-token negative log-likelihood."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels if ignore_index is None else torch.where(
        labels == ignore_index, torch.zeros_like(labels), labels)
    label_logit = logits.gather(-1, safe.long()[..., None])[..., 0]
    return logits, lse, lse - label_logit


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_index: Optional[int] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean token CE from explicit logits [..., V] and integer labels [...].

    fp32 logsumexp whatever the logits' dtype; ``ignore_index`` positions
    are left out of the mean; ``label_smoothing`` mixes in the uniform
    target's CE (``lse - mean(logits)``)."""
    logits, lse, nll = _nll(logits, labels, ignore_index)
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def _chunk_loss(h, lab, vocab_kernel, ignore_index):
    """(sum of the chunk's CE, its token count); the logits in fp32."""
    _, _, nll = _nll(h @ vocab_kernel, lab, ignore_index)
    if ignore_index is not None:
        mask = (lab != ignore_index).float()
        return (nll * mask).sum(), mask.sum()
    return nll.sum(), torch.tensor(float(lab.shape[0]), device=nll.device)


def fused_linear_cross_entropy_parts(
    hidden: torch.Tensor,
    vocab_kernel: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_index: Optional[int] = None,
    num_chunks: int = 8,
) -> tuple:
    """(sum of the CE over the tokens that are not ignored, their count),
    fp32, of :func:`fused_linear_cross_entropy`: what a rank contributes to
    a mean over the global batch (:func:`mesh_mean`)."""
    n, e = hidden.shape
    if n % num_chunks:
        num_chunks = next(c for c in range(min(num_chunks, n), 0, -1) if n % c == 0)
    chunk = n // num_chunks
    h_chunks = hidden.reshape(chunk, num_chunks, e).transpose(0, 1)
    l_chunks = labels.reshape(chunk, num_chunks).transpose(0, 1)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(num_chunks):
        s, cnt = checkpoint(_chunk_loss, h_chunks[c], l_chunks[c], vocab_kernel,
                            ignore_index, use_reentrant=False)
        total = total + s
        count = count + cnt
    return total, count


def fused_linear_cross_entropy(
    hidden: torch.Tensor,
    vocab_kernel: torch.Tensor,
    labels: torch.Tensor,
    *,
    ignore_index: Optional[int] = None,
    num_chunks: int = 8,
) -> torch.Tensor:
    """Chunked LM head + CE that never keeps the full logits.

    hidden [N, E] (batch and sequence flattened), vocab_kernel [E, V],
    labels [N] -> the mean CE over the tokens that are not ignored. When
    ``num_chunks`` does not divide N, the largest count below it that does
    is used (the reference's fallback). Chunk c holds the STRIDED rows
    {c, c + C, c + 2C, ...}, as the reference splits them; the mean does
    not depend on the split."""
    total, count = fused_linear_cross_entropy_parts(
        hidden, vocab_kernel, labels, ignore_index=ignore_index, num_chunks=num_chunks)
    return total / count.clamp(min=1.0)


def mesh_mean(total: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """``total / count`` over the global batch: on a mesh of N > 1 ranks
    the value is (sum of the ranks' totals) / (sum of their counts), and
    the gradient this rank's ``total`` x N / that count, so the mean of
    the N ranks' gradients (what the sharding strategies reduce to) is the
    gradient of the global mean: never a mean of the ranks' means."""
    if mesh is None or mesh.size() == 1:
        return total / count.clamp(min=1.0)
    import torch.distributed as dist

    both = torch.stack([total.detach().float(), count.detach().float()])
    dist.all_reduce(both)
    denom = both[1].clamp(min=1.0)
    local = total * mesh.size() / denom
    return local + (both[0] / denom - local).detach()
