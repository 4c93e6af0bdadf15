"""Per-step metrics accounting: the rolling window, flops math and the
device-memory probe.

An own copy of the part of the reference's
``accelerate_tpu/telemetry/metrics.py`` the training and serving sessions
use: :class:`MetricsWindow` (same records, same ``sys/`` rollup keys; a
training record covers one update, or K of a fused call),
:func:`batch_token_count`, :func:`decoder_flops_per_token` and
:func:`flops_per_token_fn`. Two places ask torch where the reference asks
JAX: :func:`device_memory_stats` reads ``torch.cuda.memory_stats`` (``{}``
on the CPU), and :func:`peak_flops` / :func:`peak_hbm_bw` know one card,
the H100 (dense bf16 and fp16 989 TFLOP/s, HBM3 3.35 TB/s), and return
None for anything else: a rollup with no peak leaves its MFU key out rather than
invent one. The reference's fp8 amax health probe belongs to a later item
of the port (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import statistics
from collections import deque
from typing import Callable, Optional

import numpy as np

# the cards the port knows peaks for: (name fragment, dense bf16 FLOP/s,
# HBM bytes/s). Public spec sheet of the H100 SXM
PEAKS = (("H100", 989e12, 3.35e12),)


def _card_peak(device_name: Optional[str], col: int) -> Optional[float]:
    if device_name is None:
        try:
            import torch

            if not torch.cuda.is_available():
                return None
            device_name = torch.cuda.get_device_name(0)
        except Exception:
            return None
    for frag, *vals in PEAKS:
        if frag.lower() in str(device_name).lower():
            return vals[col]
    return None


def peak_flops(device_name: Optional[str] = None) -> Optional[float]:
    """Peak dense bf16 / fp16 FLOP/s of ``device_name`` (default: CUDA
    device 0); None when the card is not one the port knows."""
    return _card_peak(device_name, 0)


def peak_hbm_bw(device_name: Optional[str] = None) -> Optional[float]:
    """Peak device-memory bytes/s of ``device_name`` (default: CUDA device
    0); None when the card is not one the port knows."""
    return _card_peak(device_name, 1)


def decoder_flops_per_token(num_params: int, num_layers: int, seq_len: int,
                            embed_dim: int) -> float:
    """Training FLOPs per token for a causal decoder: 6N weight FLOPs +
    causal attention 6*L*S*E (the reference's headline formula)."""
    return 6 * num_params + 6 * num_layers * seq_len * embed_dim


def flops_per_token_fn(model_config) -> Optional[Callable[[int], float]]:
    """seq_len -> FLOPs/token for a model config that carries the decoder
    accounting fields (num_params/num_layers/embed_dim); None otherwise —
    MFU is then simply not reported rather than reported wrong."""
    try:
        n = int(model_config.num_params)
        layers = int(model_config.num_layers)
        embed = int(model_config.embed_dim)
    except (AttributeError, TypeError, ValueError):
        return None
    return lambda seq_len: decoder_flops_per_token(n, layers, int(seq_len), embed)


def batch_token_count(batch) -> tuple:
    """Best-effort (tokens, samples, seq_len) for a batch of tensors or
    arrays.

    Token-shaped inputs (``input_ids``/``labels``/``decoder_input_ids``)
    give exact counts; anything else falls back to samples-only (leading
    dim of the first array leaf), with tokens/seq_len None so downstream
    consumers omit tokens/s and MFU instead of fabricating them.
    """
    leaf = None
    if isinstance(batch, dict):
        for key in ("input_ids", "labels", "decoder_input_ids"):
            v = batch.get(key)
            if v is not None and getattr(v, "ndim", 0) >= 1:
                shape = tuple(v.shape)
                return int(np.prod(shape)), int(np.prod(shape[:-1])), int(shape[-1])
        for v in batch.values():
            if getattr(v, "ndim", 0) >= 1:
                leaf = v
                break
    elif isinstance(batch, (tuple, list)):
        for v in batch:
            if getattr(v, "ndim", 0) >= 1:
                leaf = v
                break
    elif getattr(batch, "ndim", 0) >= 1:
        leaf = batch
    if leaf is None:
        return None, None, None
    return None, int(leaf.shape[0]), None


class MetricsWindow:
    """Rolling window of per-step records with a pure-python ``rollup()``.

    Records are plain dicts; recognized keys: ``wall_s`` (required for a
    record to count), ``steps`` (steps covered, default 1), ``tokens``,
    ``samples``, ``flops``, ``data_wait_s``, ``compile_events``,
    ``compile_s``, ``compile_cache_hits``. Unknown keys ride along
    untouched (the session keeps a record's loss and grad norm, device
    scalars until a rollup reads them, under ``_``-keys).
    """

    def __init__(self, size: int = 32):
        self.records: deque = deque(maxlen=max(1, int(size)))
        self.total_steps = 0

    def add(self, record: dict):
        self.records.append(record)
        self.total_steps += int(record.get("steps", 1))

    def last(self) -> Optional[dict]:
        return self.records[-1] if self.records else None

    def rollup(self, peak: Optional[float] = None) -> dict:
        """Aggregate the window into flat scalars (``sys/`` namespace)."""
        recs = [r for r in self.records if r.get("wall_s")]
        if not recs:
            return {}
        # normalize to per-step walls (a K-step burst record covers K
        # steps in one wall measurement)
        per_step = [float(r["wall_s"]) / max(int(r.get("steps", 1)), 1) for r in recs]
        steps = sum(int(r.get("steps", 1)) for r in recs)
        wall_total = sum(float(r["wall_s"]) for r in recs)
        out = {
            "sys/window_steps": steps,
            "sys/step_time_s": wall_total / max(steps, 1),
            "sys/step_time_p50_s": statistics.median(per_step),
            "sys/step_time_max_s": max(per_step),
        }
        tokens = sum(int(r["tokens"]) for r in recs if r.get("tokens"))
        if tokens:
            out["sys/tokens_per_s"] = tokens / wall_total
        samples = sum(int(r["samples"]) for r in recs if r.get("samples"))
        if samples:
            out["sys/samples_per_s"] = samples / wall_total
        data_wait = sum(float(r.get("data_wait_s") or 0.0) for r in recs)
        out["sys/data_wait_s"] = data_wait
        out["sys/data_wait_frac"] = min(data_wait / wall_total, 1.0)
        flops = sum(float(r["flops"]) for r in recs if r.get("flops"))
        if flops:
            out["sys/model_flops_per_s"] = flops / wall_total
            if peak:
                out["sys/mfu_pct"] = 100.0 * flops / wall_total / peak
        for key in ("compile_events", "compile_s", "compile_cache_hits"):
            total = sum(r.get(key) or 0 for r in recs)
            if total:
                out[f"sys/{key}"] = round(total, 4) if key == "compile_s" else total
        return out


# last-seen peak bytes per device index, so successive flight-recorder
# bundles report the watermark DELTA ("which incident grew the peak").
# Only ``per_device=True`` (the bundle path) reads or advances these marks
_PEAK_MARKS: dict = {}


def device_memory_stats(per_device: bool = False, devices=None) -> dict:
    """Live/peak device memory from ``torch.cuda.memory_stats`` (the
    caching allocator's counters: a host-side query, no device sync).

    ``{}`` on a process that has not initialized CUDA (the CPU). Device 0
    provides the ``sys/mem_*`` gauges; ``per_device=True`` (the bundle)
    adds every device's peak and its growth since the previous bundle
    (``sys/mem_peak_delta_bytes`` + ``_d<i>`` keys). ``devices`` is a list
    of device indices (default: every visible one)."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        if devices is None:
            devices = range(torch.cuda.device_count())
        stats_of = torch.cuda.memory_stats
        limit_of = torch.cuda.get_device_properties
    except Exception:
        return {}
    out = {}
    deltas = []
    for i in devices:
        try:
            stats = stats_of(i)
        except Exception:
            stats = None
        if not stats:
            continue
        cur = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        if i == 0:
            if isinstance(cur, (int, float)):
                out["sys/mem_bytes_in_use"] = int(cur)
            if isinstance(peak, (int, float)):
                out["sys/mem_peak_bytes"] = int(peak)
            try:
                out["sys/mem_bytes_limit"] = int(limit_of(i).total_memory)
            except Exception:
                pass
        if not per_device or not isinstance(peak, (int, float)):
            continue
        last = _PEAK_MARKS.get(i)
        delta = int(peak - last) if last is not None else 0
        _PEAK_MARKS[i] = peak
        deltas.append(delta)
        out[f"sys/mem_peak_bytes_d{i}"] = int(peak)
        out[f"sys/mem_peak_delta_bytes_d{i}"] = delta
    if deltas:
        out["sys/mem_peak_delta_bytes"] = max(deltas)
    return out
