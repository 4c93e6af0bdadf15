"""Autoregressive generation with a KV cache, and the token sampler the
serving engine shares.

Counterpart of ``accelerate_tpu/generation.py``. :func:`generate` runs the
prompt once through the model (whole-prompt prefill: the flash forward
kernel where the shapes allow, writing the cache), samples the first
token from the last row, then runs ``max_new_tokens - 1`` decode steps
against the cache (the dense decode kernel). The cache is right-sized as
the reference does (:func:`_right_size_cache`).

The decode step (:func:`_decode_body`) reads its token and position from
device buffers and writes through the slot-arena branch of the model
(``cache_positions``), so nothing in it depends on a host value. On CUDA
it is captured once per call as a CUDA graph (``utils/cuda_graphs.py``)
and replayed for every step, the token fed back on the device and read
once at the end: the counterpart of the reference's ``lax.scan`` decode
loop. The CPU runs the same body eagerly.

What the reference keeps beside it has nothing to do in eager PyTorch:
its jit caches of compiled prefill and decode programs (``_LOOP_CACHE``,
``_SIZED_DEF_CACHE``, ``clear_generation_caches``) exist so that a
definition re-hits its compiled loops, and the port compiles nothing; a
right-sized "definition" is here only the cache length handed to
:meth:`DecoderLM.init_cache`. A pipelined model (``pipeline_stages`` > 1,
or a mesh's ``stage`` axis) generates through :func:`depipeline`, which
folds its stages back into one stack: a decode step is serial across
stages, so the schedule buys nothing there.

:func:`generate_seq2seq` is the encoder-decoder's (``models/seq2seq.py``):
the source is encoded once, the prefill runs the start token through the
decoder (writing its self-attention cache, freezing the cross-attention
K/V and mask), then ``max_new_tokens - 1`` decode steps follow, each the
replay of one CUDA graph (:func:`_seq2seq_body`: its token, position,
self-attention cache and the frozen cross K/V are fixed device buffers).
Its cache is ``max_cache_len`` wide, as the reference's (not right-sized);
the dense decode kernel reads only each step's live positions.

:func:`generate_dispatched` is :func:`generate` over a big-model
``DispatchedModel`` (``big_modeling.py``): its disk-tier weights are
made pinned host tensors once per call, then the same eager prefill and
captured decode step run, with each block's host-tier weights copied
into their device buffer inside the step. Every such step captures: a
copy from pinned memory with ``non_blocking=True`` is an asynchronous
memcpy a graph records (a blocking copy would synchronize, which a
capture refuses), and the dispatch path holds host-tier weights only in
pinned memory on CUDA (a failed pin raises).

Greedy is ``argmax``, which returns the first maximum in both frameworks,
so greedy tokens agree with the reference given equal logits.
Temperature and top-k sampling draw from the caller's ``torch.Generator``,
or, without one, from a fresh generator seeded with 0 for each call, as
the reference takes ``PRNGKey(0)`` when given no key: two calls then
give the same tokens. Its bits differ from ``jax.random``'s, so sampled
tokens are compared by distribution, not token for token.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from .utils import cuda_graphs

# right-sized caches round prompt + budget up to this many positions
_CACHE_BUCKET = 256


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int]) -> torch.Tensor:
    """logits [N, V] fp32 -> token ids [N] (int64)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def _right_size_cache(config, prompt_len: int, max_new_tokens: int) -> int:
    """The cache length generate() allocates: an explicit
    ``config.max_cache_len`` as it is; else prompt + budget rounded up to a
    256 bucket and capped at ``max_seq_len`` (decode cost follows the
    cache length, so a short generation should not pay for a
    max_seq_len cache). When even the cap is short, ``max_seq_len``, so
    the capacity check raises."""
    if config.max_cache_len is not None:
        return int(config.max_cache_len)
    need = prompt_len + max_new_tokens
    sized = min(-(-need // _CACHE_BUCKET) * _CACHE_BUCKET, config.max_seq_len)
    return sized if sized >= need else int(config.max_seq_len)


def depipeline(model):
    """``model`` with its pipeline stages folded back into one stack (the
    reference's ``depipeline``): a model of the same family whose config
    has ``pipeline_stages`` 1 and no mesh, holding ``model``'s tensors on
    one process. On a ``stage`` axis every rank gathers every block first
    (a broadcast per tensor from the rank that holds it, a collective of
    the stage group), as the reference folds ``stage`` into ``data``. A
    model that is not pipelined is returned as it is. :func:`generate`,
    :func:`generate_seq2seq` and the ``ServingEngine`` call it; a loop
    that generates often calls it once and keeps the result."""
    import dataclasses

    if getattr(model, "num_stages", 1) <= 1:
        return model
    from .models.convert import whole
    from .parallel.pipeline import every_stage

    cfg = dataclasses.replace(model.config, pipeline_stages=1)
    state = every_stage(model, dict(model.state_dict()))
    state = {k: whole(v) if hasattr(v, "fetch_whole") else v for k, v in state.items()}
    return model.rebuilt(cfg, mesh=None, state=state)


def _decode_body(model, cache, tok: torch.Tensor, pos: torch.Tensor, greedy: bool):
    """One decode step of :func:`generate` on device buffers, what its CUDA
    graph captures: ``tok`` [B] through the model at position ``pos`` [B]
    (int64), the greedy argmax written back into ``tok``, ``pos`` one
    further. Returns the logits [B, V] (a sampled step draws from them
    outside the graph)."""
    logits = model(tok[:, None], pos[:, None], cache=cache, cache_positions=pos)[:, -1]
    if greedy:
        tok.copy_(torch.argmax(logits, dim=-1))
    pos.add_(1)
    return logits


@torch.no_grad()
def generate(
    model,
    input_ids,
    *,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    return_prefill_seconds: bool = False,
):
    """Generate ``max_new_tokens`` continuations of ``input_ids`` [B, S]
    with ``model`` (a ``DecoderLM``, on the device it was built on).
    ``temperature=0`` is greedy; otherwise tokens are drawn from
    ``generator``, and without one from ``torch.Generator`` seeded with 0
    once per call (the reference's ``PRNGKey(0)``), so the call is
    reproducible. Returns [B, S + max_new_tokens] token ids (int64, on
    the model's device), and the prefill wall time in seconds when asked
    (the TTFT component; the device is synchronised before the clock
    stops)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    model = depipeline(model)
    dev = model.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, s = input_ids.shape
    cap = _right_size_cache(model.config, s, max_new_tokens)
    if s + max_new_tokens > cap:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the KV cache "
            f"capacity ({cap}); raise config.max_cache_len"
        )
    cache = model.init_cache(b, cap)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    t0 = time.perf_counter()
    logits = model(input_ids, torch.arange(s, device=dev), cache=cache)
    tok = _sample(logits[:, -1], generator, temperature, top_k)
    if return_prefill_seconds and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prefill_seconds = time.perf_counter() - t0

    out = torch.empty((b, max_new_tokens), dtype=torch.long, device=dev)
    out[:, 0] = tok
    if max_new_tokens > 1:
        pos = torch.full((b,), s, dtype=torch.long, device=dev)
        greedy = temperature == 0.0
        step = functools.partial(_decode_body, model, cache, tok, pos, greedy)
        if cuda_graphs.captures(dev):
            step = cuda_graphs.capture(step, dev, restore=(tok, pos)).replay
        for i in range(1, max_new_tokens):
            logits = step()
            if not greedy:
                tok.copy_(_sample(logits, generator, temperature, top_k))
            out[:, i] = tok
    result = torch.cat([input_ids, out], dim=1)
    if return_prefill_seconds:
        return result, prefill_seconds
    return result


def generate_dispatched(dispatched, input_ids, **kwargs):
    """:func:`generate` over a ``DispatchedModel``: its weights where they
    are (device, pinned host, disk, quantized), disk-tier weights made
    pinned once for the call. Takes :func:`generate`'s keyword arguments."""
    with dispatched._concrete():
        return generate(dispatched.model, input_ids, **kwargs)


def _seq2seq_body(model, cache, tok: torch.Tensor, pos: torch.Tensor, greedy: bool):
    """One decode step of :func:`generate_seq2seq` on device buffers, what
    its CUDA graph captures: ``tok`` [B] through the decoder at position
    ``pos`` [B] (int64) against the self-attention cache and the frozen
    cross-attention K/V, the greedy argmax written back into ``tok``,
    ``pos`` one further. Returns the logits [B, V]."""
    logits = model.decode(tok[:, None], positions=pos[:, None], cache=cache,
                          cache_positions=pos)[:, -1]
    if greedy:
        tok.copy_(torch.argmax(logits, dim=-1))
    pos.add_(1)
    return logits


@torch.no_grad()
def generate_seq2seq(
    model,
    input_ids,
    *,
    max_new_tokens: int = 32,
    attention_mask=None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    return_prefill_seconds: bool = False,
):
    """Encoder-decoder generation with ``model`` (a ``Seq2SeqLM``, on the
    device it was built on): ``input_ids`` [B, T] sources (right-padded
    rows masked by ``attention_mask`` [B, T]) -> [B, max_new_tokens]
    generated ids (int64, without the start token). Greedy at
    ``temperature=0``; otherwise drawn from ``generator``, and without one
    from a fresh ``torch.Generator`` seeded with 0 (the reference's
    ``PRNGKey(0)``). With ``return_prefill_seconds``, also the wall time of
    the encoder and the prefill (the TTFT; the device is synchronised
    before the clock stops)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    model = depipeline(model)
    cfg = model.config
    dev = model.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, t = input_ids.shape
    if t > cfg.max_seq_len:
        raise ValueError(f"source length {t} exceeds config.max_seq_len={cfg.max_seq_len}")
    cap = cfg.max_cache_len or cfg.max_target_len
    # positions written: the start token at prefill and max_new_tokens - 1
    # decode appends (the last sampled token is returned, never fed back)
    if max_new_tokens > cap:
        raise ValueError(f"max_new_tokens ({max_new_tokens}) exceeds the decoder KV cache "
                         f"capacity ({cap}); raise config.max_cache_len")
    mask = None if attention_mask is None else torch.as_tensor(attention_mask, device=dev)
    cache = model.init_cache(b, cap)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    t0 = time.perf_counter()
    enc = model.encode(input_ids, mask)
    start = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    logits = model.decode(start, enc, mask, cache=cache)
    tok = _sample(logits[:, -1], generator, temperature, top_k)
    if return_prefill_seconds and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prefill_seconds = time.perf_counter() - t0

    out = torch.empty((b, max_new_tokens), dtype=torch.long, device=dev)
    out[:, 0] = tok
    if max_new_tokens > 1:
        pos = torch.ones((b,), dtype=torch.long, device=dev)
        greedy = temperature == 0.0
        step = functools.partial(_seq2seq_body, model, cache, tok, pos, greedy)
        if cuda_graphs.captures(dev):
            step = cuda_graphs.capture(step, dev, restore=(tok, pos)).replay
        for i in range(1, max_new_tokens):
            logits = step()
            if not greedy:
                tok.copy_(_sample(logits, generator, temperature, top_k))
            out[:, i] = tok
    if return_prefill_seconds:
        return out, prefill_seconds
    return out


def generate_seq2seq_dispatched(dispatched, input_ids, **kwargs):
    """:func:`generate_seq2seq` over a ``DispatchedModel`` of a
    ``Seq2SeqLM``: its weights where they are (device, pinned host, disk,
    quantized), disk-tier weights made pinned once for the call. Takes
    :func:`generate_seq2seq`'s keyword arguments."""
    with dispatched._concrete():
        return generate_seq2seq(dispatched.model, input_ids, **kwargs)
