"""The telemetry session: training step records, request records, SLO
histograms, spans, goodput, per-tenant usage and the flight recorder,
behind one object the accelerator and the engines feed.

An own copy of the reference's ``accelerate_tpu/telemetry`` session::

    from accelerate_tpu_torch.telemetry import TelemetryConfig, TelemetrySession

    session = TelemetrySession(TelemetryConfig(trace_dir="runs/telemetry"))
    engine = ServingEngine(model, page_size=16, telemetry=session)
    ...                      # or: no telemetry= and current_session() is used
    session.close()          # drains the tracer, writes the snapshots

or, training, ``Accelerator(telemetry=TelemetryConfig(...), log_with="jsonl")``
and ``accelerator.log_system_metrics()`` after each update:

- **training steps**: one record per optimizer update (the eager loop's
  ``on_optimizer_step``, the fused step's ``on_step``), with tokens from
  the batches (``note_batch``), data wait from the loaders
  (``note_data_wait``), FLOPs from the model config and the rollup's
  ``sys/tokens_per_s``, ``sys/mfu_pct``, ``sys/loss``, ``sys/grad_norm``,
  ``sys/loss_scale`` and ``sys/last_step_skipped``; with
  ``metrics_jsonl`` one line per record in ``metrics-host<i>.jsonl``;
- **profiler windows** (``recorder.CaptureWindow``): ``torch.profiler``
  over steps N..M (``profile_steps``) or after an ITL p99 breach;

- **request tracing** (``requests.py``): one JSONL record per request in
  ``requests-host<i>.jsonl`` (queue wait, prefill chunks, ITL series,
  outcome), with the reference's keys;
- **SLO histograms** (``histograms.py``): ``serving/queue_wait``,
  ``serving/ttft`` and ``serving/itl`` with exemplar reservoirs, in every
  rollup and the Prometheus exposition (``exporter.py``, optional scrape
  thread);
- **spans** (``spans.py``): a Chrome-trace JSONL per host; ``utils/phases``
  rides it (``checkpoint/save`` and ``checkpoint/restore`` among them);
- **goodput** (``goodput.py``): session wall split into compute,
  checkpoint, data wait and idle;
- **per-tenant usage** (``usage.py``): tokens, page-seconds, compute ms
  and outcome counts;
- **flight recorder** (``recorder.py``): a bounded event ring and the
  debug bundle it dumps on an unhandled exception, on SIGTERM (which also
  requests a serving drain) or on ``dump()``;
- **timeline** (``timeline.py``): every rollup gauge sampled on a
  background thread every ``timeline_interval_s`` (0: call
  ``sample_timeline()`` yourself) into a multi-resolution ring, persisted
  to ``timeline-host<i>.jsonl``; the exposition's
  ``att_scrape_age_seconds`` is its freshness;
- **alerts** (``alerts.py``): threshold and multi-window burn-rate rules
  evaluated on each sample (``alerts-host<i>.jsonl``, the exposition's
  ``att_alert_firing`` series, ``alerts/*`` rollup gauges).

Where the reference asks JAX, the port asks torch: its compile counters
become the CUDA graph capture counter (``utils/cuda_graphs``), device
memory is ``torch.cuda.memory_stats``, and the peaks are the H100's
(``metrics.peak_flops``; None, and no MFU key, on another device).

Parts that come later are not built; ``TelemetrySession.unported`` names
each with the ROADMAP item that owns it, and a config that switches one on
explicitly raises: nothing degrades silently.

Everything is off unless a session exists (or ``ATT_TELEMETRY=1`` with
``resolve_config``); when off, the engine's only cost is one ``is None``
check per hook.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

from .histograms import StreamingHistogram, percentile_keys  # noqa: F401 (public API)
from .spans import SpanRecorder, load_chrome_trace, span  # noqa: F401 (public API)

_ACTIVE_SESSION: Optional["TelemetrySession"] = None


def __getattr__(name):
    # ``metrics.py`` needs numpy, which the router's box may not have: its
    # public names load at first use (PEP 562)
    if name in ("MetricsWindow", "batch_token_count", "flops_per_token_fn"):
        from . import metrics

        return getattr(metrics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# the reference's session parts the port does not build yet, and who owns
# each (ROADMAP queue 1)
UNPORTED = {
    "forensics": "no counterpart: the port's recompile is a graph capture, "
                 "which compiles_in_flight counts",
    "cost_registry": "per-executable roofline rows, ROADMAP queue 1 item 11",
    "watchdog": "the heartbeat watchdog, ROADMAP queue 1 item 10",
}


def current_session() -> Optional["TelemetrySession"]:
    return _ACTIVE_SESSION


def note_data_wait(seconds: float):
    """The data loaders' hook: host time spent producing or placing a
    batch, billed to the next step record. A ``None`` check when no
    session is active."""
    s = _ACTIVE_SESSION
    if s is not None:
        s.note_data_wait(seconds)


@dataclass
class TelemetryConfig:
    """Knobs for the telemetry session: every field of the reference's
    ``TelemetryConfig``, at the reference's default.

    ``trace_dir`` is where per-host artifacts land (span JSONL, request
    records, flight bundles, snapshots). When None, file-producing
    features stay off (histograms, usage and the flight ring still run).
    The fields of parts the port does not build yet (forensics, cost
    registry and watchdog) keep their defaults here;
    switching one of them on explicitly raises in
    :class:`TelemetrySession`.
    """

    enabled: bool = True
    window: int = 32                       # rolling window, in step records
    flush_every: int = 0                   # auto-flush every N steps (0 = manual)
    trace_dir: Optional[str] = None
    spans: bool = True                     # stream engine/user spans to JSONL
    span_ring: int = 64                    # in-memory closed-span ring
    annotate_device: bool = False          # bridge spans into torch.profiler
    metrics_jsonl: bool = False            # per-step records to metrics-host<i>.jsonl
    metrics_path: Optional[str] = None     # exact per-step JSONL path (overrides)
    device_memory: bool = True
    flops_per_token: Optional[float] = None  # override the model-derived accounting
    watchdog: bool = False
    watchdog_deadline_s: float = 300.0
    watchdog_poll_s: Optional[float] = None
    heartbeat_dir: Optional[str] = None    # shared dir for cross-host straggler naming
    # request-level tracing + SLO histograms
    request_log: bool = True               # per-request JSONL records (needs trace_dir)
    token_span_every: int = 0              # per-token decode spans for 1-in-N requests
    itl_series_max: int = 512              # ITL samples kept per request record
    exporter_port: Optional[int] = None    # Prometheus scrape thread (0 = ephemeral port)
    exemplars: bool = True                 # exemplar reservoirs on the SLO histograms
    # JSONL artifact retention (artifacts.py)
    artifact_max_bytes: int = 64 * 1024 * 1024
    artifact_generations: int = 3
    # the explanatory layer
    forensics: bool = True
    goodput: bool = True
    cost_registry: bool = True
    # the continuous ops plane
    # the continuous ops plane: the sampler thread runs every
    # timeline_interval_s; 0 starts no thread (call sample_timeline())
    timeline: bool = True
    timeline_interval_s: float = 1.0
    timeline_tiers: Optional[tuple] = None  # ((interval_s, capacity), ...)
    alerts: bool = True                     # evaluate rules per sample
    alert_rules: Optional[list] = None      # default: alerts.default_ruleset()
    alert_itl_slo_ms: Optional[float] = None  # ITL burn-rate rule SLO
    usage: bool = True                     # per-tenant usage accounting
    # flight recorder
    flight_recorder: bool = True
    flight_events: int = 256               # bounded event ring capacity
    flight_hooks: bool = True              # dump on sys.excepthook / SIGTERM
    # SIGTERM additionally requests a serving drain: attached engines stop
    # admitting, shed their queues, and the live loop finishes in-flight
    # requests, so every request ends with a definite outcome
    drain_on_sigterm: bool = True
    # trigger-based profiler capture windows
    profile_steps: Optional[tuple] = None
    profile_window_steps: int = 16
    profile_trigger_itl_p99_ms: Optional[float] = None
    profile_dir: Optional[str] = None

    @classmethod
    def from_env(cls) -> Optional["TelemetryConfig"]:
        """ATT_TELEMETRY=1 enables defaults; ATT_TELEMETRY_DIR sets
        trace_dir; ATT_TELEMETRY_WATCHDOG_S enables the watchdog with that
        deadline; ATT_TELEMETRY_PORT starts the Prometheus scrape thread;
        ATT_TELEMETRY_PROFILE_STEPS="N:M" arms a capture window for steps
        N..M. Returns None when the env asks for nothing. (The watchdog
        then raises in the session: a later item.)"""
        flag = os.environ.get("ATT_TELEMETRY", "").strip().lower()
        wd = os.environ.get("ATT_TELEMETRY_WATCHDOG_S", "").strip()
        if flag in ("", "0", "false") and not wd:
            return None
        cfg = cls()
        d = os.environ.get("ATT_TELEMETRY_DIR", "").strip()
        if d:
            cfg.trace_dir = d
        if wd:
            cfg.watchdog = True
            cfg.watchdog_deadline_s = float(wd)
        port = os.environ.get("ATT_TELEMETRY_PORT", "").strip()
        if port:
            try:
                cfg.exporter_port = int(port)
            except ValueError:
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring malformed ATT_TELEMETRY_PORT=%r (expected an "
                    "integer port; 0 = ephemeral)", port,
                )
        win = os.environ.get("ATT_TELEMETRY_PROFILE_STEPS", "").strip()
        if win:
            lo, _, hi = win.partition(":")
            try:
                cfg.profile_steps = (int(lo), int(hi))
            except ValueError:
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring malformed ATT_TELEMETRY_PROFILE_STEPS=%r "
                    "(expected N:M, e.g. 100:120)", win,
                )
        return cfg


def resolve_config(telemetry) -> Optional[TelemetryConfig]:
    """Argument resolution: None -> env, True -> defaults, config
    passthrough (honoring .enabled), anything falsy -> off."""
    if telemetry is None:
        return TelemetryConfig.from_env()
    if telemetry is True:
        return TelemetryConfig()
    if isinstance(telemetry, TelemetryConfig):
        return telemetry if telemetry.enabled else None
    if not telemetry:
        return None
    raise TypeError(
        f"telemetry= expects a TelemetryConfig, True/False or None; got {telemetry!r}"
    )


def _refuse_unported(config: TelemetryConfig):
    """Raise for a field switched on explicitly whose part the port does
    not build yet (its default leaves the part off silently)."""
    asked = []
    if config.watchdog:
        asked.append(("watchdog=True", "watchdog"))
    if config.heartbeat_dir:
        asked.append(("heartbeat_dir", "watchdog"))
    if asked:
        raise NotImplementedError(
            "TelemetryConfig asks for parts the port does not build yet: "
            + "; ".join(f"{field} ({UNPORTED[part]})" for field, part in asked)
        )


def _process_index() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


_UNPROBED = object()


class TelemetrySession:
    """One live telemetry pipeline: the accelerator's training steps and
    serving engines feed it, ``rollup()`` and ``flush()`` drain it.

    Installed as the process-global session (``current_session()``), so an
    engine built without ``telemetry=`` attaches to it. A new session
    closes the one it replaces. ``accelerator`` (the training owner) gives
    a default ``trace_dir`` (``<logging_dir>/telemetry``) and the trackers
    ``flush()`` logs through.
    """

    def __init__(self, config: TelemetryConfig, accelerator=None):
        global _ACTIVE_SESSION
        _refuse_unported(config)
        if _ACTIVE_SESSION is not None:
            # a replaced session must not leak its hooks / fds
            _ACTIVE_SESSION.close()
        self.config = config
        self._accelerator = accelerator
        self.process_index = _process_index()
        self.trace_dir = config.trace_dir
        if self.trace_dir is None and accelerator is not None:
            logging_dir = getattr(accelerator, "logging_dir", None)
            if logging_dir:
                self.trace_dir = os.path.join(str(logging_dir), "telemetry")
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
        from .metrics import MetricsWindow

        self.window = MetricsWindow(config.window)
        self.unported = dict(UNPORTED)
        self._serving: list = []
        self._engines: list = []       # training owners (attach_engine)
        self._data_wait = 0.0
        self._pend_tokens = 0
        self._pend_samples = 0
        self._pend_seq_len = None
        self._last_opt_t: Optional[float] = None
        self._flops_fn = None
        self._peak = _UNPROBED
        self._peak_bw = _UNPROBED
        self._closed = False

        self.recorder: Optional[SpanRecorder] = None
        if config.spans and self.trace_dir:
            from . import spans as _spans

            self.recorder = _spans.arm(
                os.path.join(self.trace_dir, f"trace-host{self.process_index}.jsonl"),
                self.process_index, ring=config.span_ring,
                annotate_device=config.annotate_device,
            )

        self._metrics_fh = None
        path = config.metrics_path
        if path is None and config.metrics_jsonl and self.trace_dir:
            path = os.path.join(self.trace_dir, f"metrics-host{self.process_index}.jsonl")
        if path:
            self._metrics_fh = self.artifact_writer(path)

        from ..utils.cuda_graphs import capture_counters

        self._compile_mark = capture_counters()

        self.goodput = None
        if config.goodput:
            from . import goodput as _goodput

            self.goodput = _goodput.arm(_goodput.GoodputLedger())

        # SLO histograms + the request tracer (serving engines feed both)
        self.hists: dict = {}
        from .requests import RequestTracer

        req_path = None
        if config.request_log and self.trace_dir:
            req_path = os.path.join(self.trace_dir, f"requests-host{self.process_index}.jsonl")
        self.requests = RequestTracer(
            self, req_path, itl_series_max=config.itl_series_max,
            token_span_every=config.token_span_every,
        )

        self.flight = None
        if config.flight_recorder:
            from .recorder import FlightRecorder

            self.flight = FlightRecorder(
                self, dump_dir=self.trace_dir, capacity=config.flight_events,
                process_index=self.process_index,
                drain_serving=config.drain_on_sigterm,
            )
            if config.flight_hooks:
                self.flight.install_hooks()

        self.usage = None
        if config.usage:
            from .usage import UsageAccountant

            self.usage = UsageAccountant()
        # the ops plane: the sampled timeline and the alert rules evaluated
        # on its cadence, built before the exporter (which renders the
        # alert_firing series). The exposition's freshness clock advances
        # on every sample: None until the first (no age gauge no sampler
        # will ever advance)
        self.last_sample_unix_s = None
        self.timeline = None
        self.alerts = None
        self._sampler = None
        if config.timeline:
            from .timeline import Timeline, TimelineSampler

            self.timeline = Timeline(tiers=config.timeline_tiers)
            if config.alerts:
                from . import alerts as _alerts

                rules = config.alert_rules
                if rules is None:
                    rules = _alerts.default_ruleset(itl_slo_ms=config.alert_itl_slo_ms)
                apath = None
                if self.trace_dir:
                    apath = os.path.join(self.trace_dir,
                                         f"alerts-host{self.process_index}.jsonl")
                self.alerts = _alerts.AlertManager(
                    self.timeline, rules, session=self, log_path=apath,
                    exemplar_source=self._alert_exemplars)
            if config.timeline_interval_s and config.timeline_interval_s > 0:
                self._sampler = TimelineSampler(
                    self.sample_timeline, config.timeline_interval_s).start()
        self.forensics = None
        self.costs = None
        self.watchdog = None
        self.capture = None
        if config.profile_steps or config.profile_trigger_itl_p99_ms is not None:
            pdir = config.profile_dir or (
                os.path.join(self.trace_dir, "profile") if self.trace_dir else None)
            if pdir:
                from .recorder import CaptureWindow

                start, stop = config.profile_steps or (None, None)
                self.capture = CaptureWindow(pdir, start_step=start, stop_step=stop,
                                             window_steps=config.profile_window_steps)

        self.exporter = None
        if config.exporter_port is not None:
            from .exporter import ScrapeServer

            self.exporter = ScrapeServer(self, port=config.exporter_port)

        _ACTIVE_SESSION = self

    # -- setup helpers -----------------------------------------------------

    def attach_engine(self, engine):
        """Wire a training owner (the port's ``Accelerator``, which carries
        the reference ``TrainEngine``'s ``step_count``, ``scale_state``,
        ``last_step_skipped()`` and ``model_config``): its updates feed
        the step records, its model config the FLOPs per token."""
        engine.telemetry = self
        if engine not in self._engines:
            self._engines.append(engine)
        if self.config.flops_per_token:
            fpt = float(self.config.flops_per_token)
            self._flops_fn = lambda seq_len: fpt
        elif self._flops_fn is None:
            from .metrics import flops_per_token_fn

            cfg = getattr(engine, "model_config", None)
            if cfg is not None:
                self._flops_fn = flops_per_token_fn(cfg)

    def attach_serving(self, engine):
        """Wire a serving engine: its ``serving/`` gauges join every
        rollup and its decode steps feed the rolling window through
        ``on_step``. Held by WEAK reference: a dropped engine (and its
        cache arena) must not be pinned for the session's lifetime."""
        import weakref

        if not any(ref() is engine for ref in self._serving):
            self._serving.append(weakref.ref(engine))

    def histogram(self, name: str) -> StreamingHistogram:
        """Get-or-create the named SLO histogram (e.g. ``serving/ttft``;
        values in seconds). Percentiles join every rollup as
        ``{name}_p50_ms``/``_p95_ms``/``_p99_ms`` and the Prometheus
        exposition as a native histogram."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = StreamingHistogram()
            h.exemplars_enabled = bool(self.config.exemplars)
        return h

    def artifact_writer(self, path: str):
        """A bounded-rotation JSONL appender for ``path`` honoring the
        session's retention config."""
        from .artifacts import ArtifactWriter

        return ArtifactWriter(
            path,
            max_bytes=self.config.artifact_max_bytes,
            max_generations=self.config.artifact_generations,
        )

    def request_drain_serving(self):
        """Ask every attached serving engine to drain (flag-only: stop
        admitting, shed the queue; the loop already driving the engine
        finishes the in-flight requests). Called from the flight
        recorder's SIGTERM hook: host bookkeeping only, safe from a
        signal handler."""
        for ref in list(self._serving):
            engine = ref()
            if engine is None:
                continue
            try:
                engine.request_drain()
            except Exception:
                pass

    def _alert_exemplars(self, key: str) -> list:
        """Exemplar requests of the histogram behind an alert rule's key,
        stamped on a firing edge's event: the log names culprit requests."""
        from .alerts import exemplars_for_key

        return exemplars_for_key(self.hists, key)

    def sample_timeline(self, now: Optional[float] = None) -> dict:
        """One timeline tick: a device-free rollup folded into the
        timeline, the usage integrals brought current, one alert pass.
        ``now`` overrides the sample's timestamp (deterministic tests);
        the freshness clock reads the wall clock all the same."""
        tl = self.timeline
        if tl is None:
            return {}
        values = self.host_rollup()
        t = tl.add_sample(values, now=now)
        self.last_sample_unix_s = time.time()
        if self.usage is not None:
            self.usage.mark()
        if self.alerts is not None:
            self.alerts.evaluate(now=t)
        return values

    # -- producers ---------------------------------------------------------

    def note_data_wait(self, seconds: float):
        self._data_wait += float(seconds)

    def note_batch(self, args, kwargs, argnames: tuple = ()):
        """Eager path: count the tokens of one model call (micro-steps
        accumulate until the update drains them). ``argnames`` is the
        model's positional parameter order, so ``model(input_ids,
        labels)`` counts the same as the keyword form."""
        from .metrics import batch_token_count

        named = {argnames[i]: a for i, a in enumerate(args) if i < len(argnames)}
        named.update(kwargs)
        batch = named if named else (args[0] if len(args) == 1 else args)
        tokens, samples, seq_len = batch_token_count(batch)
        if tokens:
            self._pend_tokens += tokens
        if samples:
            self._pend_samples += samples
        if seq_len:
            self._pend_seq_len = seq_len

    def on_optimizer_step(self, engine):
        """Eager-loop boundary: the record's wall is the time since the
        previous boundary (data, forward, backward and update). The first
        boundary only starts the clock."""
        now = time.perf_counter()
        wall = None if self._last_opt_t is None else now - self._last_opt_t
        self._last_opt_t = now
        tokens, self._pend_tokens = self._pend_tokens, 0
        samples, self._pend_samples = self._pend_samples, 0
        seq_len, self._pend_seq_len = self._pend_seq_len, None
        if wall is None:
            return
        loss = getattr(engine, "_pending_loss", None)
        self.on_step(engine, wall, tokens=tokens or None, samples=samples or None,
                     seq_len=seq_len, metrics={"loss": loss} if loss is not None else None)

    def on_step(self, engine, wall_s: float, tokens=None, samples=None, seq_len=None,
                steps: int = 1, metrics: Optional[dict] = None):
        """Record one completed step: a training update (or a fused
        K-update call, ``steps=K``), or a decode or verify step (or a
        K-step burst). Feeds the step window, the goodput ledger, the span
        file, the flight ring and the capture window. Host arithmetic; a
        loss or grad norm in ``metrics`` stays a device scalar until a
        rollup reads it."""
        step = engine.step_count
        data_wait, self._data_wait = self._data_wait, 0.0
        comp = self._drain_compile()
        if self.goodput is not None:
            self.goodput.on_step(wall_s, compile_s=comp["compile_s"], data_wait_s=data_wait)
        rec = {
            "step": step,
            "wall_s": float(wall_s),
            "steps": int(steps),
            "data_wait_s": data_wait,
            "tokens": tokens,
            "samples": samples,
            "seq_len": seq_len,
            **comp,
        }
        if tokens and seq_len and self._flops_fn is not None:
            rec["flops"] = tokens * self._flops_fn(seq_len)
        if metrics:
            rec["_loss"] = metrics.get("loss")
            rec["_grad_norm"] = metrics.get("grad_norm")
        self.window.add(rec)
        if self.recorder is not None:
            # the reference's span name, which its serving engines emit too
            self.recorder.emit("engine/train_step", time.perf_counter() - wall_s, wall_s,
                               cat="engine", args={"step": step, "steps": steps})
        if self._metrics_fh is not None:
            self._write_step_record(rec)
        if self.flight is not None:
            self.flight.note("step", step=step, steps=steps,
                             wall_ms=round(wall_s * 1e3, 2), tokens=tokens)
        if self.capture is not None:
            thr = self.config.profile_trigger_itl_p99_ms
            if thr is not None and not self.capture.active:
                itl = self.hists.get("serving/itl")
                # a few samples must accrue before a p99 means anything
                if itl is not None and itl.count >= 16:
                    p99 = itl.quantile(0.99)
                    if p99 is not None and p99 * 1e3 > thr:
                        self.capture.arm("itl_p99_slo")
            self.capture.on_step(step)
        fe = self.config.flush_every
        if fe and len(self.window.records) and self.window.total_steps % fe == 0:
            self.flush(step=step)

    def _drain_compile(self) -> dict:
        """Captures since the previous step record, under the reference's
        compile keys."""
        from ..utils.cuda_graphs import capture_counters

        now = capture_counters()
        mark, self._compile_mark = self._compile_mark, now
        return {
            "compile_events": now["count"] - mark["count"],
            "compile_s": now["seconds"] - mark["seconds"],
            "compile_cache_hits": now["cache_hits"] - mark["cache_hits"],
        }

    # -- consumers ---------------------------------------------------------

    @staticmethod
    def _resolve(value) -> Optional[float]:
        """A host float of a metric (a device scalar is read here)."""
        if value is None:
            return None
        try:
            return float(value)
        except (TypeError, ValueError, RuntimeError):
            return None

    def _write_step_record(self, rec: dict):
        import json

        if self._metrics_fh is None or self._metrics_fh.closed:
            return
        out = {k: v for k, v in rec.items() if not k.startswith("_") and v is not None}
        out["time_unix_s"] = round(time.time(), 3)
        if rec.get("tokens") and rec.get("wall_s"):
            out["tokens_per_s"] = rec["tokens"] / rec["wall_s"]
        peak = self.peak_flops()
        if rec.get("flops") and rec.get("wall_s") and peak:
            out["mfu_pct"] = 100.0 * rec["flops"] / rec["wall_s"] / peak
        for key in ("loss", "grad_norm"):
            value = self._resolve(rec.get("_" + key))
            if value is not None:
                out[key] = value
        self._metrics_fh.write_line(json.dumps(out))

    def peak_flops(self) -> Optional[float]:
        """Peak dense bf16 FLOP/s of CUDA device 0, None off an H100."""
        if self._peak is _UNPROBED:
            from .metrics import peak_flops

            self._peak = peak_flops()
        return self._peak

    def peak_hbm_bw(self) -> Optional[float]:
        """Peak device-memory bytes/s of CUDA device 0, None off an H100."""
        if self._peak_bw is _UNPROBED:
            from .metrics import peak_hbm_bw

            self._peak_bw = peak_hbm_bw()
        return self._peak_bw

    def _engine_gauges(self, out: dict):
        self._serving = [ref for ref in self._serving if ref() is not None]
        for ref in self._serving:
            engine = ref()
            if engine is None:
                continue
            try:
                out.update(engine.metrics())  # host-side deque/counter math
            except Exception:  # a dying engine must not take the flush down
                pass

    def _training_gauges(self, out: dict):
        """The last record's loss and grad norm, and each training owner's
        loss scale, skipped flag and fp8 amax health (the reference's
        rollup keys)."""
        last = self.window.last()
        if last is not None:
            for key in ("loss", "grad_norm"):
                value = self._resolve(last.get("_" + key))
                if value is not None:
                    out["sys/" + key] = value
        for engine in self._engines:
            scale = getattr(engine, "scale_state", None)
            if scale is not None:
                out["sys/loss_scale"] = float(scale["scale"])
                out["sys/last_step_skipped"] = bool(engine.last_step_skipped())
            extra = getattr(engine, "extra_state", None)
            if isinstance(extra, dict) and "fp8_stats" in extra:
                from .metrics import fp8_amax_health

                out.update(fp8_amax_health(extra["fp8_stats"]))

    def rollup(self) -> dict:
        """Aggregate the rolling window plus the training and engine
        gauges into one flat dict of scalars (the ``log_system_metrics``
        payload)."""
        out = self.window.rollup(peak=self.peak_flops())
        last = self.window.last()
        if last is not None:
            out["sys/step"] = last["step"]
        self._training_gauges(out)
        # lifetime SLO histograms first, then the serving-engine gauges:
        # where the keys overlap (serving/itl_p50/_p95_ms) the engine's
        # recent-window view wins, as in the reference
        for name, hist in list(self.hists.items()):
            out.update(percentile_keys(name, hist))
        self._engine_gauges(out)
        if self.goodput is not None:
            out.update(self.goodput.rollup_keys())
        if self.usage is not None:
            out.update(self.usage.rollup_keys())
        if self.alerts is not None:
            out.update(self.alerts.rollup_keys())
        if self.config.device_memory:
            from .metrics import device_memory_stats

            out.update(device_memory_stats())
        return out

    def host_rollup(self) -> dict:
        """``rollup()`` minus every device interaction (no memory query, no
        peak probe): what the flight recorder snapshots, possibly from a
        signal handler against a wedged card."""
        peak = None if self._peak is _UNPROBED else self._peak
        out = self.window.rollup(peak=peak)
        last = self.window.last()
        if last is not None:
            out["sys/step"] = last["step"]
        for name, hist in list(self.hists.items()):
            out.update(percentile_keys(name, hist))
        self._engine_gauges(out)
        if self.goodput is not None:
            out.update(self.goodput.rollup_keys())
        if self.usage is not None:
            out.update(self.usage.rollup_keys())
        if self.alerts is not None:
            out.update(self.alerts.rollup_keys())
        return out

    def flush(self, step: Optional[int] = None) -> dict:
        """Rollup, logged through the accelerator's trackers when it has
        some, noted in the flight ring, and the goodput / usage snapshots
        refreshed. Returns the values."""
        values = self.rollup()
        if not values:
            return values
        acc = self._accelerator
        if acc is not None and getattr(acc, "trackers", None):
            acc.log(values, step=values.get("sys/step") if step is None else step)
        if self.flight is not None:
            self.flight.note_snapshot(values)
        self._write_artifacts()
        return values

    def _write_artifacts(self):
        """Refresh the offline snapshots (goodput ledger, usage table)."""
        if not self.trace_dir:
            return
        try:
            if self.goodput is not None:
                self.goodput.write_snapshot(os.path.join(
                    self.trace_dir, f"goodput-host{self.process_index}.json"))
            if self.timeline is not None:
                self.timeline.flush_jsonl(os.path.join(
                    self.trace_dir, f"timeline-host{self.process_index}.jsonl"))
            if self.usage is not None:
                self.usage.write_snapshot(os.path.join(
                    self.trace_dir, f"usage-host{self.process_index}.json"))
        except OSError:
            pass

    def close(self):
        """Detach the engines, stop the sampler and the scrape thread,
        uninstall the flight hooks, write the snapshots, close the alert
        log, drain the tracer (live requests become ``evicted`` records)
        and disarm the spans and the ledger."""
        global _ACTIVE_SESSION
        if self._closed:
            return
        self._closed = True
        for ref in self._serving:
            engine = ref()
            if engine is not None and getattr(engine, "telemetry", None) is self:
                engine.telemetry = None  # a live server must not feed a closed session
        if self._sampler is not None:
            self._sampler.stop()
        if self.timeline is not None and self.timeline.sample_count == 0:
            # a session shorter than the sampling interval still leaves one
            # sample behind
            try:
                self.sample_timeline()
            except Exception:
                pass
        if self.capture is not None:
            self.capture.close()
        if self.exporter is not None:
            self.exporter.close()
        if self.flight is not None:
            self.flight.uninstall_hooks()
        self._write_artifacts()
        if self.alerts is not None:
            self.alerts.close()
        if self.goodput is not None:
            from . import goodput as _goodput

            if _goodput.ledger() is self.goodput:
                _goodput.disarm()
        self.requests.close()
        if self.recorder is not None:
            from . import spans as _spans

            if _spans.recorder() is self.recorder:
                _spans.disarm()
            else:
                self.recorder.close()
        if self._metrics_fh is not None:
            self._metrics_fh.close()
        if _ACTIVE_SESSION is self:
            _ACTIVE_SESSION = None
