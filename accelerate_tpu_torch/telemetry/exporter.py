"""Prometheus text exposition (version 0.0.4) of a telemetry session, and
the scrape thread that serves it.

An own copy of the reference's ``accelerate_tpu/telemetry/exporter.py``:
``prometheus_text`` and the helpers it calls, and ``ScrapeServer``. It
renders a session's rolling gauges (``rollup()``), its freshness clock
(``last_sample_unix_s``), its alert states (``alerts``) and its latency
histograms with their exemplars (``hists``); the replica server serves it
on ``/metrics``, from the attached session or, with none, from an
engine-gauge shim (``serving/replica_server.py``).

Exposition hardening (dynamic keys carry tenant ids and executable
names, which the process does not control): metric names are sanitized
to ``[a-zA-Z0-9_:]``, label values are escaped per the 0.0.4 format
(``\\``, ``"``, newline), and a warn-once **cardinality cap** bounds a
runaway dynamic gauge family: a scrape endpoint must degrade, never
amplify, a tenant-id explosion.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Optional

# connections a server's kernel queue holds while its accept loop waits
LISTEN_BACKLOG = 1024


def http_server(address, handler):
    """A ``ThreadingHTTPServer`` (a daemon thread a request) whose listen
    backlog holds ``LISTEN_BACKLOG`` connections. socketserver's default
    of 5 overflows when a burst of requests (and scrapes) arrives while
    the accept loop waits for the GIL behind a busy engine thread: the
    kernel then drops the SYNs, the client resends them after 1 s and 3 s,
    and a 2 s scrape or a 5 s connect times out on a live server."""
    import http.server

    class Server(http.server.ThreadingHTTPServer):
        request_queue_size = LISTEN_BACKLOG
        daemon_threads = True

    return Server(address, handler)

# exposition metric names allow [a-zA-Z_:][a-zA-Z0-9_:]*; the att_ prefix
# guarantees the first character, the sub() the rest
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
PREFIX = "att_"

# one process exporting more gauge series than this is a bug (a dynamic
# key family — tenant ids, executable names — growing without bound);
# the exposition truncates and warns once rather than melt the scraper
MAX_SERIES = 4096
_cardinality_warned = False


def _metric_name(key: str) -> str:
    """``serving/ttft_p50_ms`` -> ``att_serving_ttft_p50_ms`` (sanitized
    to the exposition charset — tenant ids and executable names are
    interpolated into keys and may carry anything)."""
    return PREFIX + _NAME_RE.sub("_", key.strip("/"))


def escape_label_value(value) -> str:
    """Label-value escaping per exposition format 0.0.4: backslash,
    double quote, and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int,)):
        return str(v)
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    return repr(f)


def _warn_cardinality(n: int):
    global _cardinality_warned
    if _cardinality_warned:
        return
    _cardinality_warned = True
    import logging

    logging.getLogger(__name__).warning(
        "telemetry exposition holds %d gauge series (cap %d): a dynamic "
        "key family (tenant ids? executable names?) is growing without "
        "bound — series beyond the cap are dropped from the scrape. "
        "Bound the producer (SchedulerConfig.max_tenants, "
        "UsageAccountant(max_tenants=...)) instead of raising the cap.",
        n, MAX_SERIES,
    )


def prometheus_text(session) -> str:
    """Render the session's gauges + histograms + alert states as
    Prometheus exposition text. Never raises on a sick session: a gauge
    source that throws is skipped (a scrape must not take the serving
    loop down)."""
    lines = []
    try:
        values = session.rollup()
    except Exception:
        values = {}
    keys = sorted(values)
    if len(keys) > MAX_SERIES:
        _warn_cardinality(len(keys))
        keys = keys[:MAX_SERIES]
    for key in keys:
        v = values[key]
        if isinstance(v, (dict, list, tuple, str)):
            continue
        name = _metric_name(key)
        lines.append(f"# HELP {name} {key}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(v)}")
    # freshness marker: seconds since the session last folded a timeline
    # sample (i.e. since its gauges were last known to be advancing). A
    # fleet collector uses this to tell a frozen *session* (endpoint
    # answers, sampler dead, age grows -> replica "degraded") from a
    # frozen *replica* (scrape fails -> "unreachable").
    last_sample = getattr(session, "last_sample_unix_s", None)
    if isinstance(last_sample, (int, float)) and last_sample > 0:
        lines.append(f"# TYPE {PREFIX}scrape_age_seconds gauge")
        lines.append(
            f"{PREFIX}scrape_age_seconds "
            f"{_fmt(max(0.0, time.time() - last_sample))}"
        )
    alerts = getattr(session, "alerts", None)
    if alerts is not None:
        try:
            states = alerts.states_snapshot()
            if states:
                lines.append(f"# TYPE {PREFIX}alert_firing gauge")
                for rule in sorted(states):
                    st = states[rule]
                    lines.append(
                        f'{PREFIX}alert_firing{{rule="{escape_label_value(rule)}"}} '
                        f'{1 if st["state"] == "firing" else 0}'
                    )
        except Exception:  # alert state must not fail the scrape
            pass
    for hname, hist in sorted(list(getattr(session, "hists", {}).items())):
        try:
            buckets = hist.cumulative_buckets()
            if not buckets:
                continue
            # the serving thread may add() mid-scrape; derive the total
            # from the snapshot so the +Inf bucket stays consistent
            count = buckets[-1][1]
            base = _metric_name(hname) + "_seconds"
            lines.append(f"# HELP {base} {hname} latency histogram")
            lines.append(f"# TYPE {base} histogram")
            exemplars = {}
            try:
                exemplars = hist.exposition_exemplars()
            except Exception:
                pass
            for le, cum in buckets:
                line = f'{base}_bucket{{le="{le:.9g}"}} {cum}'
                ex = exemplars.get(le)
                if ex is not None:
                    # OpenMetrics exemplar syntax: the bucket line carries
                    # a sampled request id + its exact value/timestamp —
                    # the p99's path back to a concrete request
                    labels = f'request_id="{escape_label_value(ex["request_id"])}"'
                    if ex.get("replica"):
                        labels += f',replica="{escape_label_value(ex["replica"])}"'
                    line += (f' # {{{labels}}} {ex["value"]:.9g}'
                             f' {ex.get("unix_s") or 0:.3f}')
                lines.append(line)
            lines.append(f'{base}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{base}_sum {_fmt(hist.sum)}")
            lines.append(f"{base}_count {count}")
            for q in (0.50, 0.95, 0.99):
                tag = f"p{int(q * 100)}"
                lines.append(f"# TYPE {base}_{tag} gauge")
                lines.append(f"{base}_{tag} {_fmt(hist.quantile(q))}")
        except Exception:  # a racing histogram must not fail the scrape
            continue
    return "\n".join(lines) + "\n"


class ScrapeServer:
    """``/metrics`` scrape endpoint over the live session, on a daemon
    thread. ``port=0`` binds an ephemeral port; a configured port that is
    already in use **falls back to port 0** (the resolved port is logged
    and exposed as ``.port``) — a stale scraper holding the port must
    neither kill a training run nor silently cost the telemetry. Only an
    unbindable host degrades to a warning with the endpoint disabled."""

    def __init__(self, session, port: int = 0, host: str = "127.0.0.1"):
        import http.server
        import logging

        self.session = session
        self.server = None
        self.port: Optional[int] = None
        self.requested_port = port
        self._thread: Optional[threading.Thread] = None
        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # a slow or wedged client only ever costs its own handler
            # thread (ThreadingHTTPServer below), and that thread is
            # reclaimed by the socket timeout — a stuck fleet poller must
            # not block the on-call's manual curl, or accumulate threads
            timeout = 10.0

            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = prometheus_text(exporter.session).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        log = logging.getLogger(__name__)
        try:
            self.server = http_server((host, port), Handler)
        except OSError as first_err:
            if port:
                try:
                    self.server = http_server((host, 0), Handler)
                    log.warning(
                        "telemetry exporter could not bind %s:%s (%s); "
                        "fell back to ephemeral port %s",
                        host, port, first_err, self.server.server_address[1],
                    )
                except OSError as e:
                    log.warning(
                        "telemetry exporter could not bind %s (%s); scrape "
                        "endpoint disabled", host, e,
                    )
                    return
            else:
                log.warning(
                    "telemetry exporter could not bind %s:%s (%s); scrape "
                    "endpoint disabled", host, port, first_err,
                )
                return
        # concurrent scrapes must never serialize behind one slow client:
        # each request gets its own daemon thread (explicit — the close()
        # join must not wait out a client that never finishes reading)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="att-telemetry-exporter",
            daemon=True,
        )
        self._thread.start()

    def close(self):
        """Shut the scrape thread down and join it: a wedged exporter
        thread must never be what holds the process open at exit."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
