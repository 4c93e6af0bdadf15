"""The placement-signal contract: :func:`load_score`, the one comparable
scalar every ``ServingEngine`` exports as ``serving/load_score`` and a
router ranks replicas by (lower is more attractive). A copy of the
reference's ``accelerate_tpu/telemetry/fleet.py:load_score``, formula
unchanged, so port and reference replicas rank alike."""

from __future__ import annotations

from typing import Optional

# a draining/unplaceable replica's score is pushed past anything a live
# replica can reach — routers comparing raw scores still never pick it
DRAINING_PENALTY = 1e6
# ITL term normalizer when no SLO is configured: p99 at 100 ms counts as
# one full "unit" of load, comparable to a 100%-occupied slot arena
DEFAULT_ITL_NORM_MS = 100.0


def load_score(
    *,
    queue_depth: float = 0.0,
    num_slots: float = 1.0,
    slot_occupancy: float = 0.0,
    free_pages: Optional[float] = None,
    pages_total: Optional[float] = None,
    itl_recent_p99_ms: Optional[float] = None,
    itl_slo_ms: Optional[float] = None,
    draining: bool = False,
) -> float:
    """THE load-score formula (the stable router contract; lower = more
    attractive)::

        score = queue_depth / num_slots              # queued work per slot
              + slot_occupancy                       # 0..1 slots busy
              + (1 - free_pages / pages_total)       # paged arena only
              + itl_recent_p99_ms / (itl_slo_ms or 100)   # latency pressure
              + 1e6 if draining                      # never place on a drain

    Every term is monotone in the obvious direction: more queue, fewer
    free pages, or worse recent ITL strictly raises the score. Raw
    components stay exported beside the scalar (``serving/queue_depth``,
    ``serving/free_slots``, ``serving/free_pages``,
    ``serving/itl_recent_p99_ms``, ``serving/draining``) so a router that
    wants its own weighting can recompute without a replica-side change."""
    score = float(queue_depth) / max(float(num_slots), 1.0)
    score += float(slot_occupancy)
    if pages_total:
        used = 1.0 - float(free_pages or 0.0) / float(pages_total)
        score += min(max(used, 0.0), 1.0)
    if itl_recent_p99_ms is not None:
        score += float(itl_recent_p99_ms) / float(itl_slo_ms or DEFAULT_ITL_NORM_MS)
    if draining:
        score += DRAINING_PENALTY
    return round(score, 6)
