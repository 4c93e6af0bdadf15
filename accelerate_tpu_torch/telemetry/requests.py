"""Request-level tracing for the serving stack.

An own copy of the reference's ``accelerate_tpu/telemetry/requests.py``:
the same hooks and the same record keys, so a tool that reads the
reference's ``requests-host<i>.jsonl`` reads the port's. Where the
reference counts XLA compiles in flight, the port counts CUDA graphs
captured in flight (``utils/cuda_graphs.capture_counters``), under the
same ``compiles_in_flight`` key: after ``warmup()`` both must stay 0.

Aggregate gauges answer "is the engine healthy"; they cannot answer "why
was *this* request slow". The tracer records every request's full
lifecycle — queue wait → each bucketed prefill chunk → per-token decode
ITL → eos/eviction, with the slot id and compile-counter snapshots — and
publishes it three ways:

- **one structured JSONL record per request** (``requests-host<i>.jsonl``
  in the telemetry dir): queue-wait/TTFT/total latency, the prefill chunk
  plan with per-chunk walls, the ITL series (bounded by
  ``TelemetryConfig.itl_series_max``), finish reason, and how many graph
  captures fired while the request was in flight (a nonzero delta names
  the capture that ate the latency budget);
- **nestable spans** in the same Chrome-trace JSONL stream the engine
  already writes: a ``serving/request`` span covering submit→finish plus
  ``serving/queue_wait`` and ``serving/prefill_chunk`` children, all
  carrying ``request_id`` args so the ``trace`` CLI can filter one
  request out of a merged multi-host trace. Per-token spans are behind
  the ``token_span_every`` sampling knob (1-in-N requests) because at
  production token rates they dominate the file;
- **SLO histograms** (``histograms.py``): queue-wait, TTFT and ITL feed
  log-bucketed streaming histograms whose p50/p95/p99 ride every
  ``TelemetrySession.rollup()`` and the Prometheus exposition.

Everything here is host-side bookkeeping on events the engine already
pays for (the per-token ``perf_counter`` exists for the ITL gauge); the
marginal cost is one method call and a few dict writes per event.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional


class RequestTracer:
    """Per-request lifecycle recorder fed by ``ServingEngine`` hooks.

    One tracer per :class:`TelemetrySession`; live requests are tracked in
    ``_live`` (what the flight recorder dumps as "in flight") and drained
    to the JSONL file at finish.
    """

    def __init__(self, session, path: Optional[str] = None,
                 itl_series_max: int = 512, token_span_every: int = 0):
        self.session = session
        self.itl_series_max = max(0, int(itl_series_max))
        self.token_span_every = max(0, int(token_span_every))
        self._live: dict = {}  # request id -> in-progress record
        self._lock = threading.Lock()
        self._fh = None
        self.path = path
        self.records_written = 0
        if path:
            if session is not None and hasattr(session, "artifact_writer"):
                self._fh = session.artifact_writer(path)
            else:
                from .artifacts import ArtifactWriter

                self._fh = ArtifactWriter(path)

    @staticmethod
    def _compiles() -> int:
        from ..utils.cuda_graphs import capture_counters

        return capture_counters()["count"]

    def _recorder(self):
        return self.session.recorder if self.session is not None else None

    @staticmethod
    def _exemplar(rec: dict) -> dict:
        """The exemplar descriptor stamped onto histogram observations:
        the live request's id (+ serving replica, when known) — what lets
        a p99 bucket name the concrete request that put it there. Built
        once per request at submit (``rec["_exemplar"]``) — the per-token
        hook reuses it, and ``on_finish`` strips it before the JSONL
        record lands."""
        ex = rec.get("_exemplar")
        if ex is None:
            ex = rec["_exemplar"] = {"request_id": rec["request_id"]}
            replica = rec.get("replica")
            if replica:
                ex["replica"] = replica
        return ex

    # -- engine hooks (one call per lifecycle event) -----------------------

    def on_submit(self, req):
        rec = {
            "request_id": req.id,
            "prompt_len": int(req.prompt.size),
            "max_new_tokens": int(req.max_new_tokens),
            "tenant": getattr(req, "tenant", "default"),
            "priority": int(getattr(req, "priority", 0) or 0),
            "submit_unix_s": round(time.time(), 6),
            "state": "queued",
            "slot": None,
            "prefill_chunks": [],
            "itl_ms": [],
            "tokens": 0,
            "compiles_at_submit": self._compiles(),
            "last_event": ("submit", time.time()),
        }
        # fleet identity: which replica served this hop. A re-queued
        # request keeps its external request_id across replicas, and the
        # trace CLI stitches the per-replica records by (id, replica)
        replica = getattr(req, "replica", None)
        if replica:
            rec["replica"] = str(replica)
        with self._lock:
            self._live[req.id] = rec
        flight = getattr(self.session, "flight", None)
        if flight is not None:
            flight.note("request_submit", request_id=req.id,
                        prompt_len=rec["prompt_len"])

    def on_admission(self, req, slot: int, queue_wait_s: float):
        rec = self._live.get(req.id)
        if rec is None:
            return
        rec["state"] = "prefill"
        rec["slot"] = int(slot)
        rec["queue_wait_ms"] = round(queue_wait_s * 1e3, 3)
        rec["last_event"] = ("admission", time.time())
        self.session.histogram("serving/queue_wait").observe(
            queue_wait_s, exemplar=self._exemplar(rec)
        )
        recorder = self._recorder()
        if recorder is not None:
            recorder.emit("serving/queue_wait", req.submit_t, queue_wait_s,
                          cat="serving", args={"request_id": req.id, "slot": slot})

    def on_prefill_chunk(self, req, slot: int, start: int, bucket: int,
                         t0: float, wall_s: float):
        """One bucketed prefill chunk dispatched. ``wall_s`` is the host
        dispatch wall (a mid-prompt dispatch returns before its compute
        lands; the dispatch that reads first tokens back to the host makes
        its wall real)."""
        rec = self._live.get(req.id)
        if rec is None:
            return
        rec["prefill_chunks"].append(
            {"start": int(start), "bucket": int(bucket),
             "ms": round(wall_s * 1e3, 3)}
        )
        rec["last_event"] = ("prefill_chunk", time.time())
        recorder = self._recorder()
        if recorder is not None:
            recorder.emit("serving/prefill_chunk", t0, wall_s, cat="serving",
                          args={"request_id": req.id, "slot": slot,
                                "start": start, "bucket": bucket})

    def on_preempt(self, req):
        """A live request was paged out (its slot and KV pages released,
        its RNG chain saved); it re-enters the queue at the front of its
        class. The record keeps a preemption count so a slow request's
        latency is attributable to scheduling, not the chip."""
        rec = self._live.get(req.id)
        if rec is None:
            return
        rec["state"] = "preempted"
        rec["slot"] = None
        rec["preemptions"] = rec.get("preemptions", 0) + 1
        rec["last_event"] = ("preempt", time.time())

    def on_resume(self, req, slot: int):
        """A preempted request was re-admitted (replay prefill done, chain
        restored) and is decoding again."""
        rec = self._live.get(req.id)
        if rec is None:
            return
        rec["state"] = "decode"
        rec["slot"] = int(slot)
        rec["last_event"] = ("resume", time.time())

    def on_first_token(self, req, ttft_s: float):
        rec = self._live.get(req.id)
        if rec is None:
            return
        rec["state"] = "decode"
        rec["ttft_ms"] = round(ttft_s * 1e3, 3)
        rec["tokens"] = 1
        rec["last_event"] = ("first_token", time.time())
        self.session.histogram("serving/ttft").observe(
            ttft_s, exemplar=self._exemplar(rec)
        )

    def on_token(self, req, gap_s: float, token_index: int):
        """One decode token after the first; ``gap_s`` is the inter-token
        latency the engine already measured."""
        rec = self._live.get(req.id)
        if rec is None:
            return
        rec["tokens"] = token_index + 1
        if len(rec["itl_ms"]) < self.itl_series_max:
            rec["itl_ms"].append(round(gap_s * 1e3, 3))
        rec["last_event"] = ("token", time.time())
        self.session.histogram("serving/itl").observe(
            gap_s, exemplar=self._exemplar(rec)
        )
        n = self.token_span_every
        # externally-supplied ids may be strings; hash keeps the 1-in-N
        # sampling property without constraining the id type
        rid = req.id if isinstance(req.id, int) else abs(hash(req.id))
        if n and rid % n == 0:
            recorder = self._recorder()
            if recorder is not None:
                recorder.emit("serving/decode_token",
                              time.perf_counter() - gap_s, gap_s, cat="serving",
                              args={"request_id": req.id, "token": token_index})

    def on_finish(self, req, reason: str):
        with self._lock:
            rec = self._live.pop(req.id, None)
        if rec is None:
            return
        rec.pop("state", None)
        rec.pop("last_event", None)
        rec.pop("_exemplar", None)
        rec["finish_reason"] = reason
        # the definite-outcome contract: finished | shed | cancelled (the
        # engine sets it at the single terminal transition; "finished" is
        # inferred for callers driving the tracer without an outcome)
        rec["outcome"] = getattr(req, "outcome", None) or "finished"
        shed_reason = getattr(req, "shed_reason", None)
        if shed_reason:
            rec["shed_reason"] = shed_reason
        rec["finish_unix_s"] = round(time.time(), 6)
        # paged-arena / speculative attribution (engine-owned counters on
        # the request; 0s on a flat-arena engine): how much of this
        # request's TTFT the prefix cache saved, what it cost in pages,
        # and how its draft tokens fared — what the reference's trace CLI
        # aggregates into per-burst hit/accept rates
        for attr in ("prefix_hit", "pages_allocated", "spec_proposed",
                     "spec_accepted"):
            rec[attr] = int(getattr(req, attr, 0) or 0)
        # tiered-KV restore hop: which tier fed this request's
        # prefix hit and what the pull cost — the waterfall's kv_restore
        # stage and `trace summary --request-id` read these
        kr_ms = float(getattr(req, "kv_restore_ms", 0.0) or 0.0)
        if kr_ms:
            rec["kv_restore_ms"] = round(kr_ms, 3)
            rec["kv_restore_pages"] = int(
                getattr(req, "kv_restore_pages", 0) or 0
            )
        tier = getattr(req, "kv_restore_tier", None)
        if tier:
            rec["kv_restore_tier"] = str(tier)
        # which prefill path admitted this request ("ragged" = the packed
        # flash prefill kernel, "dense" = bucketed chunks): the TTFT
        # waterfall annotates its prefill stage kernel-vs-dense from this
        pk = getattr(req, "prefill_kernel", None)
        if pk:
            rec["prefill_kernel"] = str(pk)
        total_s = (req.finish_t or time.perf_counter()) - req.submit_t
        rec["total_ms"] = round(total_s * 1e3, 3)
        rec["compiles_in_flight"] = self._compiles() - rec.pop("compiles_at_submit")
        itl = rec["itl_ms"]
        if itl:
            s = sorted(itl)
            rec["itl_p50_ms"] = s[len(s) // 2]
            rec["itl_max_ms"] = s[-1]
        with self._lock:  # two engines can drain finishes concurrently
            if self._fh is not None and not self._fh.closed:
                self._fh.write_line(json.dumps(rec))
            self.records_written += 1
        recorder = self._recorder()
        if recorder is not None:
            recorder.emit("serving/request", req.submit_t, total_s, cat="serving",
                          args={"request_id": req.id, "slot": rec.get("slot"),
                                "prompt_len": rec["prompt_len"],
                                "tokens": rec["tokens"], "reason": reason})
        flight = getattr(self.session, "flight", None)
        if flight is not None:
            flight.note("request_finish", request_id=req.id, reason=reason,
                        tokens=rec["tokens"], total_ms=rec["total_ms"])

    def _drain_live(self):
        """Requests still in flight when the tracer closes (engine
        shutdown, session teardown) drain one record each with
        ``finish_reason: "evicted"`` — submitted-vs-logged counts must
        reconcile even on an unclean exit."""
        now = time.time()
        with self._lock:
            live, self._live = list(self._live.values()), {}
            for rec in live:
                rec.pop("state", None)
                rec.pop("last_event", None)
                rec.pop("_exemplar", None)
                rec["finish_reason"] = "evicted"
                rec["outcome"] = "evicted"
                rec["finish_unix_s"] = round(now, 6)
                rec["total_ms"] = round((now - rec["submit_unix_s"]) * 1e3, 3)
                rec["compiles_in_flight"] = (
                    self._compiles() - rec.pop("compiles_at_submit")
                )
                if self._fh is not None and not self._fh.closed:
                    self._fh.write_line(json.dumps(rec))
                self.records_written += 1

    # -- consumers ---------------------------------------------------------

    def inflight(self) -> list:
        """Snapshot of every submitted-but-unfinished request — what the
        flight-recorder bundle names when the engine wedges mid-burst."""
        now = time.time()
        out = []
        with self._lock:
            for rec in self._live.values():
                ev = rec.get("last_event") or ("submit", now)
                out.append({
                    "request_id": rec["request_id"],
                    "state": rec.get("state"),
                    "slot": rec.get("slot"),
                    "prompt_len": rec["prompt_len"],
                    "tokens": rec.get("tokens", 0),
                    "age_s": round(now - rec["submit_unix_s"], 3),
                    "last_event": ev[0],
                    "last_event_age_s": round(now - ev[1], 3),
                })
        return out

    def close(self):
        self._drain_live()
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
