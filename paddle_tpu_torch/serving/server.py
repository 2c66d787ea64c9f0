"""Stdlib HTTP frontend over one or more serving engines.

Parity: the JAX package's serving/server.py (`ModelServer`, `_Handler`),
over the port's InferenceEngine and DecodeEngine. As there, the server
has no route of its own for a model's origin: it serves whatever engine
it is given, so an engine over a reference-era (era-wire) directory
(`model_format="reference"`) or over a training snapshot
(`InferenceEngine.from_checkpoint`) answers `:predict` like any other.
A ReplicaPool or DecodePool registers like an engine: `/healthz` carries
every pool's `pool_state()` and reads unavailable when no entry can
serve, `/metrics` renders the pools' {model, replica} families. A
ModelFleet given as `engines` routes every `:predict` through the fleet
(a browned-out model answers 429 with Retry-After), `/healthz` carries
its brownout level, and `shutdown` closes the fleet's intake first.

A `ThreadingHTTPServer` (one thread per connection — request threads only
normalize + enqueue + wait; the single batcher worker per engine does the
device work) serving a small JSON protocol:

    GET  /v1/models                      model list + live metrics
    POST /v1/models/<name>:predict       {"inputs": {...},
                                          "deadline_ms": optional}
    POST /v1/models/<name>:decode        {"inputs": {...},
                                          "max_new_tokens": optional,
                                          "deadline_ms": optional}
                                         -> NDJSON chunked stream, one
                                         line per decoded token
    GET  /healthz                        200 while serving, 503 after close
    GET  /metrics                        Prometheus text exposition

Input encoding per feed: dense feeds are (nested) JSON lists shaped
[rows, *feature]; sequence feeds are {"sequences": [[...], ...]} — one
inner list per sequence, ragged lengths welcome (the engine pads to the
seq bucket). Outputs come back as nested lists under "outputs", plus the
bucket the batch ran at and this request's queue latency.

Backpressure and deadlines map onto status codes a load balancer can act
on: 429 queue full (retry with backoff), 504 deadline expired, 503
shutting down, 400 malformed request, 404 unknown model.
"""
import json
import threading

import numpy as np

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .batcher import (DeadlineExceededError, QueueFullError,
                      RequestTooLargeError, ServingClosedError)
from .engine import InvalidRequestError

__all__ = ["ModelServer"]

_DEFAULT_RESULT_TIMEOUT_S = 60.0
_DEFAULT_MAX_BODY_BYTES = 64 * 1024 * 1024  # one request can't OOM us


def _status_for(exc, client_phase=False):
    """Map an exception to a status code. `client_phase`: the error came
    from decoding/normalizing/enqueueing THIS request (its own fault ->
    400); completion-phase errors are only 4xx/504 for the TYPED serving
    errors — a raw ValueError surfacing from a dispatched batch is a
    server failure (possibly another request poisoning the batch) and
    must be 500 so clients retry, not blame themselves."""
    if isinstance(exc, QueueFullError):
        return 429
    if isinstance(exc, DeadlineExceededError):
        return 504
    if isinstance(exc, ServingClosedError):
        return 503
    if isinstance(exc, (InvalidRequestError, RequestTooLargeError)):
        return 400
    if client_phase and isinstance(exc, (ValueError, KeyError, TypeError)):
        return 400
    return 500


def _decode_inputs(inputs):
    """JSON payload -> feed dict (sequence feeds become lists of
    per-sequence arrays; the engine's normalize_feed validates)."""
    if not isinstance(inputs, dict):
        raise InvalidRequestError('"inputs" must be an object of '
                                  "feed-name -> value")
    feed = {}
    for name, value in inputs.items():
        if isinstance(value, dict):
            if "sequences" not in value:
                raise InvalidRequestError(
                    'feed %r: object inputs must carry "sequences"' % name)
            feed[name] = [np.asarray(s) for s in value["sequences"]]
        else:
            feed[name] = np.asarray(value)
    return feed


class _Handler(BaseHTTPRequestHandler):
    # set by ModelServer on the generated subclass
    registry = {}
    server_ref = None
    protocol_version = "HTTP/1.1"
    # idle keep-alive connections die after this: handler threads are
    # NON-daemon (so shutdown can join them after the drain, instead of
    # the interpreter killing them mid-reply), which means a connection
    # parked in readline() must time out for server_close to return
    timeout = 5

    def log_message(self, fmt, *args):  # quiet by default; metrics tell
        if self.server_ref is not None and self.server_ref.verbose:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, status, payload, content_type="application/json",
               headers=None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode("utf-8"))
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status, exc_or_msg, code=None):
        if code is None:
            code = ("error" if isinstance(exc_or_msg, str)
                    else type(exc_or_msg).__name__)
        headers = None
        payload = {"error": str(exc_or_msg), "code": code}
        if status == 429:
            # a backoff hint (QueueFullError.retry_after_s, default 1s):
            # HTTP wants integer delay seconds (round up, floor 1), the
            # JSON carries the precise value for clients that parse
            # bodies
            hint = getattr(exc_or_msg, "retry_after_s", None) or 1.0
            payload["retry_after_s"] = round(float(hint), 3)
            headers = {"Retry-After": str(max(1, int(-(-hint // 1))))}
        self._reply(status, payload, headers=headers)

    @property
    def max_body_bytes(self):
        return (self.server_ref.max_body_bytes
                if self.server_ref is not None
                else _DEFAULT_MAX_BODY_BYTES)

    def _check_body_size(self, length):
        """Declared-length cap BEFORE any read: rfile.read(huge) would
        buffer the whole body in memory — one request could OOM the
        process and drop every in-flight batch. 413 + connection drop
        (the unread bytes would desync keep-alive otherwise)."""
        if length > self.max_body_bytes:
            self.close_connection = True
            self._error(413, "request body of %d bytes exceeds the %d "
                             "byte limit" % (length, self.max_body_bytes),
                        code="payload_too_large")
            return False
        return True

    def _drain_body(self):
        """Read and discard any request body: replying with unread bytes
        pending desyncs the HTTP/1.1 keep-alive stream (they'd parse as
        the next request line). GETs with bodies are legal per RFC."""
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length > self.max_body_bytes:
            self.close_connection = True  # drop instead of slurping it
            return
        if length:
            self.rfile.read(length)

    def do_GET(self):
        self._drain_body()
        if self.path == "/healthz":
            # an entry can serve when it is not closed and (a pool) at
            # least one replica is routable: a pool whose every replica
            # is ejected or dead reads unhealthy though the process is
            # up. pool_state() takes every replica's lock: it is called once a pool
            pool_states = {name: e.pool_state()
                           for name, e in sorted(self.registry.items())
                           if hasattr(e, "pool_state")}

            def _can_serve(name, e):
                if e.closed:
                    return False
                s = pool_states.get(name)
                if s is not None and "healthy" in s:
                    # a decode pool carries no health machine: it serves
                    # while open
                    return (s["healthy"] + s["degraded"]) > 0
                return True

            alive = any(_can_serve(n, e)
                        for n, e in self.registry.items())
            payload = {"status": "ok" if alive else "unavailable"}
            if pool_states:
                payload["pools"] = pool_states
            fleet = getattr(self.server_ref, "fleet", None)
            if fleet is not None:
                payload["fleet"] = {
                    "brownout_level": fleet.brownout_level(),
                    "pressure": round(fleet._pressure(), 4)}
            self._reply(200 if alive else 503, payload)
            return
        if self.path == "/metrics":
            from ..observability.registry import REGISTRY
            from .metrics import render_prometheus_all
            plain, pools = {}, {}
            for name, e in self.registry.items():
                if hasattr(e, "decode_stats"):
                    # decode engines and pools publish through the
                    # registry's decoder collector (ptpu_decode_*
                    # families): not ServingMetrics-shaped
                    continue
                if hasattr(e, "replica_metrics"):
                    pools[name] = e
                else:
                    plain[name] = e.metrics
            # one exposition: the serving families + the runtime registry
            # (windows, batcher queues, decoders, traces, watched
            # clusters); family names are disjoint, so HELP/TYPE stays
            # once each
            text = (render_prometheus_all(plain, pools=pools)
                    + REGISTRY.render_prometheus())
            self._reply(200, text.encode("utf-8"),
                        content_type="text/plain; version=0.0.4")
            return
        if self.path == "/v1/models":
            self._reply(200, {"models": [e.describe() for _, e in
                                         sorted(self.registry.items())]})
            return
        self._error(404, "no route %r" % self.path, code="not_found")

    def do_POST(self):
        # chunked bodies aren't supported: without a Content-Length the
        # chunk data would stay unread in rfile and desync keep-alive —
        # reject with 411 and drop the connection (RFC 7230 §3.3.3)
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            self.close_connection = True
            self._error(411, "chunked transfer encoding not supported; "
                             "send Content-Length", code="length_required")
            return
        # consume the body FIRST, before any routing decision: an error
        # reply that leaves Content-Length bytes unread desyncs the
        # keep-alive connection (protocol_version is HTTP/1.1) — the
        # stale body would parse as the NEXT request line
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not self._check_body_size(length):
            return
        raw = self.rfile.read(length) if length else b""
        prefix = "/v1/models/"
        if self.path.startswith(prefix) and self.path.endswith(":predict"):
            name, action = self.path[len(prefix):-len(":predict")], "predict"
        elif self.path.startswith(prefix) and self.path.endswith(":decode"):
            name, action = self.path[len(prefix):-len(":decode")], "decode"
        else:
            self._error(404, "no route %r" % self.path, code="not_found")
            return
        engine = self.registry.get(name)
        if engine is None:
            self._error(404, "no model %r (have: %s)"
                        % (name, sorted(self.registry)),
                        code="unknown_model")
            return
        is_decode = hasattr(engine, "decode_stats")
        if action == "decode":
            if not is_decode:
                self._error(400, "model %r is not a decode deploy; use "
                                 ":predict" % name, code="not_a_decoder")
                return
            self._stream_decode(name, engine, raw)
            return
        if is_decode:
            self._error(400, "model %r is a decode deploy; use :decode"
                        % name, code="decode_only")
            return
        try:  # client phase: decode + normalize + enqueue
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise InvalidRequestError(
                    "request body must be a JSON object, got %s"
                    % type(req).__name__)
            feed = _decode_inputs(req.get("inputs", {}))
            deadline_ms = req.get("deadline_ms")
            future = engine.submit(feed, deadline_ms=deadline_ms)
        except Exception as e:  # noqa: BLE001 — mapped to a status code
            self._error(_status_for(e, client_phase=True), e)
            return
        try:  # completion phase: batch dispatch + materialize
            timeout = _DEFAULT_RESULT_TIMEOUT_S
            if deadline_ms is not None:  # bound the wait by the deadline
                timeout = min(timeout, float(deadline_ms) / 1e3 + 5.0)
            outputs = future.result(timeout).numpy()
        except Exception as e:  # noqa: BLE001
            self._error(_status_for(e), e)
            return
        payload = {
            "outputs": {k: np.asarray(v).tolist()
                        for k, v in outputs.items()},
            "model": name,
            "bucket": list(future.bucket) if future.bucket else None,
            "latency_ms": round((future.latency_s or 0.0) * 1e3, 3)}
        try:
            # allow_nan=False: python's default would emit bare
            # NaN/Infinity tokens, which are NOT JSON — strict clients
            # would fail to decode a 200. Non-finite outputs are a
            # server-side condition worth a typed 500.
            body = json.dumps(payload, allow_nan=False).encode("utf-8")
        except ValueError:
            self._error(500, "model produced non-finite output values",
                        code="non_finite_output")
            return
        self._reply(200, body)

    def _stream_decode(self, name, engine, raw):
        """POST :decode — admit one stream into the continuous batcher
        and stream its tokens back as chunked NDJSON, one JSON line per
        token as the decode loop delivers it.
        Inter-token latency is the wire-visible contract here: the first
        line arrives after ONE decode iteration, not after the whole
        sequence. A mid-stream failure (deadline, hard close) becomes a
        final {"error": ...} line — the status code already went out
        with the first chunk, so errors ride the body. A client that
        disconnects mid-stream stops the writes; the stream itself
        decodes on to its token budget server-side (no cancel channel)."""
        try:  # client phase: decode + normalize + enqueue
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise InvalidRequestError(
                    "request body must be a JSON object, got %s"
                    % type(req).__name__)
            feed = _decode_inputs(req.get("inputs", {}))
            deadline_ms = req.get("deadline_ms")
            stream = engine.submit(feeds=feed,
                                   max_new_tokens=req.get("max_new_tokens"),
                                   deadline_ms=deadline_ms)
        except Exception as e:  # noqa: BLE001 — mapped to a status code
            self._error(_status_for(e, client_phase=True), e)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def _chunk(obj):
            data = (json.dumps(obj) + "\n").encode("utf-8")
            self.wfile.write(("%x\r\n" % len(data)).encode("ascii"))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        wait = _DEFAULT_RESULT_TIMEOUT_S
        if deadline_ms is not None:
            wait = min(wait, float(deadline_ms) / 1e3 + 5.0)
        n = 0
        try:
            try:
                while True:
                    tok = stream.next_token(timeout=wait)
                    if tok is None:
                        break
                    _chunk({"index": n,
                            "token": np.asarray(tok).reshape(-1).tolist()})
                    n += 1
            except Exception as e:  # noqa: BLE001 — typed error line
                _chunk({"error": str(e), "code": type(e).__name__,
                        "status": _status_for(e), "tokens": n})
                self.close_connection = True
            else:
                _chunk({"done": True, "model": name, "tokens": n,
                        "stream_id": stream.stream_id})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True


class ModelServer(object):
    """HTTP frontend wrapping a {name: engine} registry (a bare engine or
    pool is accepted and registered under its own name), or a ModelFleet
    (its `registry()`, fleet-routed). Entries are InferenceEngines and
    ReplicaPools (`:predict`) or DecodeEngines and DecodePools (streamed
    `:decode`). port=0 picks a free port (read `address`)."""

    def __init__(self, engines, host="127.0.0.1", port=8080,
                 verbose=False, max_body_bytes=_DEFAULT_MAX_BODY_BYTES):
        self.fleet = None
        if hasattr(engines, "registry") and callable(engines.registry):
            # a ModelFleet: its entries route submits through the fleet
            # (priority brownout); metrics stay per model
            self.fleet = engines
            engines = engines.registry()
        elif not isinstance(engines, dict):
            engines = {engines.name: engines}
        self.registry = dict(engines)
        self.verbose = verbose
        self.max_body_bytes = int(max_body_bytes)
        handler = type("BoundHandler", (_Handler,),
                       {"registry": self.registry, "server_ref": self})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        # non-daemon handler threads: server_close() joins them, so a
        # reply resolved during the shutdown drain is WRITTEN before the
        # process exits; _Handler.timeout bounds how long an idle
        # keep-alive can pin the join
        self.httpd.daemon_threads = False
        self._thread = None

    @property
    def address(self):
        host, port = self.httpd.server_address[:2]
        return "%s:%d" % (host, port)

    def start(self):
        """Serve in a background thread (tests, embedding); use
        `serve_forever()` for a foreground CLI process."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="ptt-http")
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self, drain=True):
        """Graceful stop, in dependency order: (1) stop accepting, (2)
        drain every engine so handler threads blocked in future.result
        resolve, (3) join the handler threads (server_close) so every
        drained reply is written before the process exits. Closing the
        engines AFTER server_close would deadlock: the join would wait
        on handlers that wait on futures only the drain resolves."""
        self.httpd.shutdown()
        if self.fleet is not None:
            self.fleet.closed = True   # stop fleet-routed intake first
        for engine in self.registry.values():
            engine.close(drain=drain)
        self.httpd.server_close()   # joins non-daemon handler threads
        if self._thread is not None:
            self._thread.join(timeout=10)
