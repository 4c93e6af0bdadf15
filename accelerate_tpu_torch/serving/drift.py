"""KV-quantization drift harness: what int8/int4 KV storage costs in
output quality, against the unquantized arena, on fixed seeds.

Counterpart of ``accelerate_tpu/serving/drift.py``, taking a
``DecoderLM`` where the reference takes ``definition, params``. Two
measurements:

- **token-match rate**: the same prompts and seeds through an engine
  with the compute-dtype arena and one with the quantized arena, and the
  share of continuation positions whose tokens agree. It includes
  divergence cascades (one flipped argmax reroutes the rest of a
  stream), so it is the pessimistic number;
- **teacher-forced logit error**: the baseline's continuation replayed
  token by token through both cache precisions on the single-stream path
  (``init_cache(1, cap, kv)``, whole-prompt prefill, then ``decode=True``
  steps), comparing the per-step logits: MSE, and MSE relative to the
  baseline logits' mean square. Teacher forcing removes the cascade.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.quantization import kv_cache_bits


@torch.no_grad()
def _teacher_forced_logits(model, tokens: np.ndarray, n_prompt: int, cap: int,
                           kv_cache_dtype: str) -> np.ndarray:
    """[steps, V] fp32 logits of prefill(prompt) plus teacher-forced
    single-stream decode steps over ``tokens[n_prompt:]``, on a
    ``cap``-position cache stored as ``kv_cache_dtype``: row i is the
    distribution the model holds before emitting ``tokens[n_prompt + i]``."""
    dev = model.device
    ids = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[None]
    steps = ids.shape[1] - n_prompt
    cache = model.init_cache(1, cap, kv_cache_dtype)
    rows = [model(ids[:, :n_prompt], torch.arange(n_prompt, device=dev), cache=cache)[0, -1]]
    for pos in range(n_prompt, n_prompt + steps - 1):
        rows.append(model(ids[:, pos:pos + 1], torch.arange(pos, pos + 1, device=dev),
                          cache=cache, decode=True)[0, -1])
    return torch.stack(rows).float().cpu().numpy()


def kv_quant_drift(
    model,
    prompts,
    *,
    kv_cache_dtype: str = "int8",
    max_new_tokens: int = 8,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    seeds=None,
    page_size: Optional[int] = None,
    num_slots: Optional[int] = None,
    max_cache_len: Optional[int] = None,
    prefill_chunks=None,
    logit_prompts: int = 2,
    baseline: Optional[dict] = None,
    **engine_kwargs,
) -> dict:
    """Compare a ``kv_cache_dtype`` KV arena against the compute-dtype
    ("bf16") arena of ``model`` on ``prompts`` (list of 1-D token-id
    arrays) with fixed ``seeds``. Returns the reference's keys::

        kv_cache_dtype, kv_cache_bits, token_match_rate, exact_streams,
        sequences, tokens_compared, logit_mse, logit_rel_err,
        arena_bytes_bf16, arena_bytes_quant, arena_bytes_ratio,
        arena_bytes_per_slot_bf16, arena_bytes_per_slot_quant, baseline

    ``page_size`` selects the paged arena; None the flat one. The
    engines run on the model's device. ``baseline`` (the ``"baseline"``
    dict of an earlier call with the same prompts, seeds and engine
    shape) skips re-running the unquantized engine, so int8 and int4
    compare against one baseline."""
    from .engine import ServingEngine

    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if seeds is None:
        seeds = list(range(len(prompts)))
    n_slots = num_slots or min(max(len(prompts), 1), 4)
    need = max(p.size for p in prompts) + max_new_tokens
    cap = max_cache_len or -(-need // 16) * 16
    chunks = prefill_chunks or (min(16, cap // 2), min(64, cap))
    kw = dict(num_slots=n_slots, max_cache_len=cap, prefill_chunks=tuple(sorted(set(chunks))),
              temperature=temperature, top_k=top_k, page_size=page_size,
              device=model.device, **engine_kwargs)

    def run(kvq):
        engine = ServingEngine(model, kv_cache_dtype=kvq, **kw)
        streams = engine.generate_batched(prompts, max_new_tokens=max_new_tokens, seeds=seeds)
        return streams, engine.arena_bytes, engine.num_slots

    if baseline is None:
        base, base_bytes, slots = run("bf16")
        baseline = {"streams": base, "arena_bytes": base_bytes, "num_slots": slots}
    else:
        base = baseline["streams"]
        base_bytes = baseline["arena_bytes"]
        slots = baseline["num_slots"]
    quant, quant_bytes, _ = run(kv_cache_dtype)

    matched = compared = exact = 0
    for p, a, b in zip(prompts, base, quant):
        ca, cb = np.asarray(a)[p.size:], np.asarray(b)[p.size:]
        matched += int(np.sum(ca == cb))
        compared += ca.size
        exact += int(np.array_equal(ca, cb))

    # teacher-forced logit error on the baseline's continuations
    sq_err = ref_sq = 0.0
    n_logits = 0
    for p, stream in list(zip(prompts, base))[:logit_prompts]:
        lb = _teacher_forced_logits(model, stream, p.size, cap, "bf16")
        lq = _teacher_forced_logits(model, stream, p.size, cap, kv_cache_dtype)
        sq_err += float(np.sum((lq - lb) ** 2))
        ref_sq += float(np.sum(lb ** 2))
        n_logits += lb.size
    logit_mse = sq_err / max(1, n_logits)
    return {
        "kv_cache_dtype": kv_cache_dtype,
        "kv_cache_bits": kv_cache_bits(kv_cache_dtype),
        "token_match_rate": matched / max(1, compared),
        "exact_streams": exact,
        "sequences": len(prompts),
        "tokens_compared": compared,
        "logit_mse": logit_mse,
        "logit_rel_err": logit_mse / max(1e-30, ref_sq / max(1, n_logits)),
        "arena_bytes_bf16": int(base_bytes),
        "arena_bytes_quant": int(quant_bytes),
        "arena_bytes_ratio": base_bytes / max(1, quant_bytes),
        "arena_bytes_per_slot_bf16": int(base_bytes) // slots,
        "arena_bytes_per_slot_quant": int(quant_bytes) // slots,
        "baseline": baseline,
    }
