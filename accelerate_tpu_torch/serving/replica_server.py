"""One serving replica as an HTTP process: the engine behind a wire.

An own copy of the reference's ``accelerate_tpu/serving/replica_server.py``.
:class:`ReplicaServer` wraps a live :class:`~.engine.ServingEngine` in a
stdlib-HTTP JSONL surface, the unit a router places onto, fails over
between, and scales:

- ``POST /v1/submit``: queue one request; with ``"stream": true`` the
  response is JSONL (``{"event": "token", ...}`` per emitted token, one
  terminal ``{"event": "done", ...}``), else a single JSON document. A
  connection that closes *without* the terminal event is the replica-
  death signature a router re-queues on. A re-queued continuation
  carries ``resumed_tokens`` (see :meth:`~.engine.ServingEngine.submit`).
- ``POST /v1/cancel``: ``{request_id}``; the engine frees the slot and
  pages at its next iteration.
- ``GET /metrics``: the Prometheus scrape (the engine's telemetry session
  when one is attached: its gauges, SLO histograms with exemplars and
  usage meters; else a minimal engine-gauges shim), which is what a fleet
  collector polls for health and placement.
- ``GET /v1/health``: a one-shot JSON health/identity document.
- ``POST /v1/flight``: remote-triggered flight-recorder dump
  (``{reason}``); ``{"ok": true, ...}`` when the engine's session has a
  flight recorder, whose bundle then lands in the session's trace dir,
  ``{"ok": false, ...}`` when there is none.
- ``GET /v1/kv/directory``: the digests of the prefixes this replica can
  export (the peer tier's discovery contract).
- ``POST /v1/kv/export``: ``{tokens}``; the longest cached prefix's KV
  handoff (the reference's wire format), or 404 "prefix not cached".
- ``POST /v1/kv/import``: a handoff body; ``{installed_tokens,
  replica}``, or 409 when it does not fit this engine's arena.

``faults=`` takes a
:class:`~.faults.FaultInjector` whose ``wrong_token`` drill corrupts the
tokens on the wire (``corrupt_token``), not in the engine.

Lifecycle: ``start()`` runs the engine's scheduler loop on a background
thread; the HTTP handler threads touch host state only (``submit``,
``Request.cancel``, ``metrics``, ``req.tokens``), except the three KV
endpoints, which read or write the arena's pages: they and each
``engine.step()`` hold one engine lock, so an export never reads pages a
step is writing and an import lands between steps, on the same stream.
SIGTERM, with ``handle_signals=True``,
starts the drain: ``request_drain()`` (flag-only, signal-safe), in-flight
requests finish and their streams complete, and
``serve_until_drained()`` returns. A draining replica still answers
``/metrics`` (the ``serving/draining`` gauge) and still serves its
in-flight streams; new submits shed with ``shed_reason="draining"``.

One rule is the port's own: where the reference's loop thread dies on an
exception and ``serve_until_drained()`` then waits forever, the port's
loop stores the exception, stops serving as a dead replica does (streams
break off without their terminal event) and ``serve_until_drained()``
re-raises it, so a replica whose kernel fails to launch exits non-zero
instead of looking alive. And where the reference's KV endpoints queue on
a plain lock that its busy loop re-takes the moment it lets go (a lock
is not fair: the waiting handler thread has not woken yet), so that an
import behind a stream of steps waited seconds, past a router's 5 s
timeout, the port's loop yields the engine at its next step boundary to
any endpoint that waits for it (``_engine_turn``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Optional

from ..telemetry.exporter import http_server, prometheus_text


class _EngineMetricsSession:
    """Minimal scrape shim for an engine with no telemetry session:
    ``prometheus_text`` needs ``rollup()``/``hists``/``alerts`` and a
    freshness clock. Freshness tracks the engine loop's last iteration
    (``_touch``), so a wedged loop still reads as a degrading replica."""

    def __init__(self, engine):
        self.engine = engine
        self.hists: dict = {}
        self.alerts = None
        self.last_sample_unix_s = time.time()

    def _touch(self):
        self.last_sample_unix_s = time.time()

    def rollup(self) -> dict:
        return self.engine.metrics()


class ReplicaServer:
    """HTTP wrapper around one live engine. ``name`` becomes the
    engine's ``replica`` identity (stamped into every request). ``port=0``
    binds an ephemeral port; read the resolved one from ``.port``."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 name: Optional[str] = None, handle_signals: bool = False,
                 faults=None):
        import http.server

        # replica-side fault injection (wrong-token drills): consulted per
        # emitted token through corrupt_token()
        self._faults = faults
        self.engine = engine
        if name:
            engine.replica = str(name)
        self.name = engine.replica or f"replica@{port}"
        # the engine's telemetry session when attached, else the shim
        self._session = (
            engine.telemetry if engine.telemetry is not None
            else _EngineMetricsSession(engine)
        )
        self._stop = False
        self._dead = False          # hard-fail switch (kill, a dead loop)
        self._error: Optional[BaseException] = None  # what killed the loop
        self._drained = threading.Event()
        self._engine_lock = threading.Lock()   # loop thread vs KV endpoints
        self._waiting = 0           # KV endpoints waiting for the engine lock
        self._waiting_lock = threading.Lock()
        self._live_lock = threading.Lock()
        self._live: dict = {}       # str(request_id) -> Request
        self._loop_thread: Optional[threading.Thread] = None
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            timeout = 30.0

            def do_GET(self):  # noqa: N802 (stdlib casing)
                server._get(self)

            def do_POST(self):  # noqa: N802
                server._post(self)

            def log_message(self, *args):
                pass

        self.httpd = http_server((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever,
            name=f"att-replica-http-{self.name}", daemon=True,
        )
        if handle_signals:
            self._install_signal_handler()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ReplicaServer":
        """Serve: HTTP thread + the engine scheduler loop thread."""
        self._http_thread.start()
        if self._loop_thread is None:
            self._loop_thread = threading.Thread(
                target=self._loop, name=f"att-replica-loop-{self.name}",
                daemon=True,
            )
            self._loop_thread.start()
        return self

    def _loop(self):
        shim = self._session if isinstance(self._session, _EngineMetricsSession) else None
        try:
            while not self._stop:
                with self._engine_lock:
                    busy = self.engine.step()
                while self._waiting and not self._stop:
                    time.sleep(0.0005)  # an endpoint's turn (_engine_turn)
                if shim is not None:
                    shim._touch()
                if self.engine._draining and not self.engine._pending():
                    # drain complete: every request reached its outcome and
                    # every stream's terminal event is writable
                    self.engine._flight_dump("replica_drain_complete")
                    self._drained.set()
                    return
                if not busy:
                    time.sleep(0.001)
        except Exception as exc:
            # the port's rule (module docstring): a dead loop makes a dead
            # replica, and serve_until_drained() re-raises what killed it
            self.engine._flight_dump("serving_exception")
            self._error = exc
            self._dead = True
            self._drained.set()

    @contextlib.contextmanager
    def _engine_turn(self):
        """Hold the engine lock for a KV endpoint, between two steps. The
        loop thread waits at its step boundary while an endpoint is
        counted here, so the endpoint gets the lock within one step."""
        with self._waiting_lock:
            self._waiting += 1
        try:
            with self._engine_lock:
                yield
        finally:
            with self._waiting_lock:
                self._waiting -= 1

    def serve_until_drained(self, timeout_s: Optional[float] = None) -> bool:
        """Block until a drain completes (the SIGTERM path's main-thread
        wait). True when drained; False on timeout. Re-raises the
        exception that killed the scheduler loop, if one did."""
        drained = self._drained.wait(timeout_s)
        if self._error is not None:
            raise self._error
        return drained

    def request_drain(self):
        """Stop admitting, finish in-flight, then the loop thread stops.
        Safe from a signal handler (flag-only, like the engine's)."""
        self.engine.request_drain()

    def _install_signal_handler(self):
        import signal

        def on_sigterm(signum, frame):
            self.request_drain()

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # not the main thread: the embedder owns signals

    def close(self, drain_timeout_s: float = 5.0):
        """Graceful stop: drain, wait for in-flight to finish, shut the
        HTTP server down."""
        if not self._dead:
            self.engine.request_drain()
            self._drained.wait(drain_timeout_s)
        self._stop = True
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5.0)
            self._loop_thread = None
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except OSError:
            pass
        if self._http_thread.is_alive():
            self._http_thread.join(timeout=5.0)

    def kill(self):
        """Hard-fail NOW (the in-process stand-in for SIGKILL): the
        scheduler loop stops mid-whatever, every in-flight stream breaks
        off without its terminal event, the listener closes. No drain:
        exactly what a dead process looks like from a router's side."""
        self._dead = True
        self._stop = True
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
        except OSError:
            pass

    # -- handlers (each on its own daemon thread) ---------------------------

    @staticmethod
    def _read_json(handler) -> dict:
        n = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(n) if n else b"{}"
        return json.loads(body or b"{}")

    @staticmethod
    def _send_json(handler, payload, status: int = 200):
        body = json.dumps(payload).encode()
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def _get(self, handler):
        if self._dead:
            return  # connection drops: a dead process answers nothing
        if handler.path in ("/metrics", "/"):
            body = prometheus_text(self._session).encode()
            handler.send_response(200)
            handler.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif handler.path == "/v1/health":
            m = self.engine.metrics()
            self._send_json(handler, {
                "replica": self.name,
                "draining": bool(m.get("serving/draining")),
                "load_score": m.get("serving/load_score"),
                "queue_depth": m.get("serving/queue_depth"),
                "free_slots": m.get("serving/free_slots"),
            })
        elif handler.path == "/v1/kv/directory":
            with self._engine_turn():
                directory = self.engine.kv_directory()
            self._send_json(handler, directory)
        else:
            handler.send_error(404)

    def _post(self, handler):
        if self._dead:
            return
        try:
            body = self._read_json(handler)
        except ValueError:
            handler.send_error(400, "bad json")
            return
        if handler.path == "/v1/submit":
            self._handle_submit(handler, body)
        elif handler.path == "/v1/cancel":
            self._handle_cancel(handler, body)
        elif handler.path == "/v1/kv/export":
            self._handle_kv_export(handler, body)
        elif handler.path == "/v1/kv/import":
            self._handle_kv_import(handler, body)
        elif handler.path == "/v1/flight":
            self._handle_flight(handler, body)
        else:
            handler.send_error(404)

    def _handle_flight(self, handler, body: dict):
        """Remote-triggered flight dump: an operator's curl (or a canary
        prober) captures this replica's debug bundle while a fault is
        live."""
        reason = str(body.get("reason") or "remote_request")[:64]
        try:
            dumped = bool(self.engine.flight_dump(reason))
        except Exception:
            dumped = False
        self._send_json(handler, {"ok": dumped, "replica": self.name,
                                  "reason": reason})

    # -- submit / stream ----------------------------------------------------

    def _handle_submit(self, handler, body: dict):
        prompt = body.get("prompt") or []
        if not prompt:
            handler.send_error(400, "empty prompt")
            return
        try:
            req = self.engine.submit(
                [int(t) for t in prompt],
                max_new_tokens=int(body.get("max_new_tokens") or 32),
                seed=int(body.get("seed") or 0),
                tenant=str(body.get("tenant") or "default"),
                priority=int(body.get("priority") or 0),
                deadline_s=body.get("deadline_s"),
                timeout_s=body.get("timeout_s"),
                request_id=body.get("request_id"),
                resumed_tokens=int(body.get("resumed_tokens") or 0),
            )
        except ValueError as e:
            handler.send_error(400, str(e)[:200])
            return
        rid = str(req.id)
        with self._live_lock:
            self._live[rid] = req
        try:
            if body.get("stream", True):
                self._stream_request(handler, req)
            else:
                self._await_request(handler, req)
        finally:
            with self._live_lock:
                self._live.pop(rid, None)

    def _done_event(self, req) -> dict:
        return {
            "event": "done", "request_id": req.id, "replica": self.name,
            "outcome": req.outcome, "finish_reason": req.finish_reason,
            "shed_reason": req.shed_reason,
            "tokens": [int(t) for t in req.tokens],
            "prefix_hit": int(req.prefix_hit),
        }

    def _stream_request(self, handler, req):
        """JSONL token stream. Reads ``req.tokens`` incrementally off
        the handler thread (list append is atomic; the engine loop owns
        the writes): no callback into the engine, so a slow client can
        never stall the scheduler loop. A hard-failed server breaks the
        stream off with no terminal event, a router's re-queue trigger."""
        handler.send_response(200)
        handler.send_header("Content-Type", "application/jsonl")
        handler.end_headers()
        sent = 0
        try:
            while True:
                if self._dead:
                    return  # mid-stream drop: connection closes, no "done"
                n = len(req.tokens)
                while sent < n:
                    token = int(req.tokens[sent])
                    if self._faults is not None:
                        # wrong-token drill: the engine computed the right
                        # answer, the wire lies
                        token = int(self._faults.corrupt_token(self.name, sent, token))
                    line = json.dumps({
                        "event": "token", "i": sent, "token": token,
                        "request_id": req.id, "replica": self.name,
                    })
                    handler.wfile.write((line + "\n").encode())
                    sent += 1
                handler.wfile.flush()
                if req.done and sent >= len(req.tokens):
                    handler.wfile.write(
                        (json.dumps(self._done_event(req)) + "\n").encode()
                    )
                    handler.wfile.flush()
                    return
                time.sleep(0.002)
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client went away: free the slot now
            req.cancel()

    def _await_request(self, handler, req):
        while not req.done:
            if self._dead:
                return
            time.sleep(0.002)
        self._send_json(handler, self._done_event(req))

    def _handle_cancel(self, handler, body: dict):
        rid = str(body.get("request_id"))
        with self._live_lock:
            req = self._live.get(rid)
        if req is None:
            self._send_json(handler, {"ok": False, "error": "unknown request"},
                            status=404)
            return
        self._send_json(handler, {"ok": req.cancel()})

    # -- KV handoff ---------------------------------------------------------

    def _handle_kv_export(self, handler, body: dict):
        tokens = body.get("tokens") or []
        try:
            with self._engine_turn():
                handoff = self.engine.export_prefix_kv([int(t) for t in tokens])
        except ValueError as e:
            handler.send_error(409, str(e)[:200])
            return
        if handoff is None:
            self._send_json(handler, {"error": "prefix not cached"}, status=404)
            return
        self._send_json(handler, handoff)

    def _handle_kv_import(self, handler, body: dict):
        try:
            with self._engine_turn():
                installed = self.engine.import_prefix_kv(body)
        except ValueError as e:
            handler.send_error(409, str(e)[:200])
            return
        self._send_json(handler, {"installed_tokens": int(installed),
                                  "replica": self.name})
